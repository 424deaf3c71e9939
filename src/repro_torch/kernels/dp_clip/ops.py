"""Dispatch for the DP clip-accumulate kernel, with tree support.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version.  ``clip_accumulate_tree`` flattens a
per-example gradient tree into one ``(N, D)`` f32 matrix in jax's leaf
order (the reference's layout), clips and sums it, and unflattens.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels.dp_clip.kernel import clip_accumulate_kernel
from repro_torch.kernels.dp_clip.ref import clip_accumulate_ref
from repro_torch.kernels.tick_fused.ops import on_cuda


def clip_accumulate(g, *, clip: float):
    """g: (N, D) f32 or bf16 -> (D,) f32 clipped sum."""
    if not on_cuda(g):
        return clip_accumulate_ref(g, clip)
    return clip_accumulate_kernel(g.contiguous(), clip)


def clip_accumulate_tree(grads, *, clip: float):
    """grads: tree, every leaf (N, ...).  Returns the clipped-sum tree."""
    ls = tree.leaves(grads)
    N = ls[0].shape[0]
    flat = torch.cat([l.reshape(N, -1).to(torch.float32) for l in ls], dim=1)
    out = clip_accumulate(flat, clip=clip)
    outs, off = [], 0
    for l in ls:
        size = l.numel() // N
        outs.append(out[off:off + size].reshape(l.shape[1:]))
        off += size
    return tree.unflatten(grads, outs)
