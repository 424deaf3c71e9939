"""Gaussian DP mechanism: clipping + noise (Algorithm 1 lines 17, 23-24).

The port's copy of ``repro.dp.mechanism``.  Granularities:
  * example — per-sample gradient clipping (paper-faithful / Abadi et
    al.): per-example grads via ``torch.func.vmap(grad_and_value)``,
    each clipped to C, summed, then batch noise N(0, C^2 sigma^2 I)
    added once per round (``dp_sgd_round``);
  * client  — the client's whole round update is clipped (``clip_tree``).

``dp_sgd_round`` clips and sums through
``repro_torch.kernels.dp_clip.ops.clip_accumulate_tree``: the CUDA kernel
on a CUDA tensor, its plain version on a CPU tensor.  ``clip_accumulate``
here is the plain per-leaf oracle the kernel is checked against.  Trees
are flattened in jax's leaf order (``repro_torch.tree``), so the noise
keys go to the same leaves as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch import prng, tree
from repro_torch.kernels.dp_clip.ops import clip_accumulate_tree

F32 = torch.float32


def tree_norm(t) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32)))
                          for l in tree.leaves(t)))


def clip_tree(t, clip_norm: float):
    scale = 1.0 / torch.clamp(tree_norm(t) / clip_norm, min=1.0)
    return tree.tree_map(lambda l: (l.to(F32) * scale).to(l.dtype), t)


def add_gaussian_noise(t, rng, stddev: float):
    """``leaf + stddev * normal(key_i)`` with ``key_i = split(rng, n)[i]``
    over the leaves in jax's order; ``rng`` is one key on the CPU.  The
    leaves are f32 (the reference draws bf16 normals another way)."""
    flat = tree.leaves(t)
    keys = prng.split(rng, len(flat))
    noised = []
    for l, k in zip(flat, keys):
        if l.dtype != F32:
            raise TypeError(f"noise is drawn for f32 leaves, got {l.dtype}")
        noised.append(l + stddev * prng.normal(k, tuple(l.shape),
                                                device=l.device))
    return tree.unflatten(t, noised)


def clip_accumulate(per_example_grads, clip_norm: float):
    """Clip each example's gradient tree to ``clip_norm`` and sum.

    per_example_grads: tree with a leading example axis on every leaf.
    Plain per-leaf oracle for the ``dp_clip`` kernel.
    """
    ls = tree.leaves(per_example_grads)
    # (torch.sum over an empty dim tuple would reduce every axis)
    sq = sum(torch.sum(torch.square(l.to(F32)).reshape(l.shape[0], -1), dim=1)
             for l in ls)
    norms = torch.sqrt(sq)                                 # (n_examples,)
    scales = 1.0 / torch.clamp(norms / clip_norm, min=1.0)

    def scale_sum(l):
        s = scales.reshape((-1,) + (1,) * (l.dim() - 1))
        return torch.sum(l.to(F32) * s, dim=0)

    return tree.tree_map(scale_sum, per_example_grads)


def dp_sgd_round(loss_fn: Callable, params, batch, *, clip_norm: float,
                 sigma: float, rng, microbatch: int = 0
                 ) -> Tuple[Any, torch.Tensor]:
    """One DP round over a batch: per-example clip, sum, noise.

    loss_fn(params, example) -> scalar.  batch: tree with leading axis N.
    With ``microbatch`` dividing N (and smaller), the examples go through
    in N / microbatch slices, in order, each clipped and summed on its
    own (the reference's ``lax.scan``).  Returns (U, mean_loss) with U
    distributed as the paper's round update; ``rng`` is one CPU key.
    """
    grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                              in_dims=(None, 0))

    def run(examples):
        grads, losses = grad_fn(params, examples)
        return losses, clip_accumulate_tree(grads, clip=clip_norm)

    n = tree.leaves(batch)[0].shape[0]
    if microbatch and n % microbatch == 0 and n > microbatch:
        U = tree.tree_map(lambda l: torch.zeros(l.shape, dtype=F32,
                                                device=l.device), params)
        loss_sum = torch.zeros((), dtype=F32,
                               device=tree.leaves(batch)[0].device)
        for lo in range(0, n, microbatch):
            mb = tree.tree_map(lambda l: l[lo:lo + microbatch], batch)
            losses, U_mb = run(mb)
            U = tree.tree_map(torch.add, U, U_mb)
            loss_sum = loss_sum + torch.sum(losses)
        mean_loss = loss_sum / n
    else:
        losses, U = run(batch)
        mean_loss = torch.mean(losses)

    U = add_gaussian_noise(U, rng, clip_norm * sigma)
    return U, mean_loss
