"""Plain PyTorch version of the DP clip-accumulate kernel, op for op the
reference's ``repro/kernels/dp_clip/ref.py``."""
from __future__ import annotations

import torch

from repro_torch.kernels import row_tiles


def clip_accumulate_ref(g, clip: float):
    """g: (N, D) -> (D,) f32: sum_n g[n] * min(1, clip/||g[n]||)."""
    g = g.to(torch.float32)
    norms = torch.sqrt(torch.sum(g * g, dim=1))
    scale = 1.0 / torch.clamp(norms / clip, min=1.0)
    return torch.sum(g * scale[:, None], dim=0)


# example rows of one tile, by dtype (``csrc/dp_clip.cu``)
TILE_ROWS = {torch.float32: 12, torch.bfloat16: 24}


def row_scales(g, clip: float):
    """g (N, D) -> (N,) f32 scales ``1 / max(1, ||g[n]|| / clip)`` with
    the kernel's norm: lane l of a warp adds the squares of elements l,
    l + 32, ... in order from 0, then the 32 lane sums combine as the
    xor-shuffle tree does (lanes l and l + off, off = 16, 8, 4, 2, 1)."""
    g = g.to(torch.float32)
    N, D = g.shape
    sq = g.new_zeros((N, -(-D // 32) * 32))
    sq[:, :D] = g * g                      # the padding adds +0.0: exact
    sq = sq.reshape(N, -1, 32)
    lanes = g.new_zeros((N, 32))
    for k in range(sq.shape[1]):
        lanes = lanes + sq[:, k]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
    # __fsqrt_rn and __fdiv_rn round once; torch's f32 sqrt on a large CPU
    # tensor (its vectorized path) may not.  Taken in f64 and rounded to
    # f32, a square root or quotient of f32 operands is correctly rounded
    norms = torch.sqrt(lanes[:, 0].double()).float().double()
    clips = torch.full_like(norms, clip, dtype=torch.float32).double()
    ratio = torch.clamp((norms / clips).float(), min=1.0).double()
    return (torch.ones_like(ratio) / ratio).float()


def clip_accumulate_twin(g, clip: float):
    """``clip_accumulate_ref`` with the CUDA kernel's add order
    (``row_scales``; the column sums by ``row_tiles.py``): on CPU
    tensors it gives the kernel's bits."""
    N, D = g.shape
    if N == 0:
        return torch.zeros((D,), dtype=torch.float32, device=g.device)
    rb, _ = row_tiles.partition(N, TILE_ROWS[g.dtype])
    terms = g.to(torch.float32) * row_scales(g, clip)[:, None]
    return row_tiles.finish_tree(row_tiles.block_sums(terms, rb))
