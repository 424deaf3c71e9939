"""Plain PyTorch version of the DP clip-accumulate kernel, op for op the
reference's ``repro/kernels/dp_clip/ref.py``."""
from __future__ import annotations

import torch


def clip_accumulate_ref(g, clip: float):
    """g: (N, D) -> (D,) f32: sum_n g[n] * min(1, clip/||g[n]||)."""
    g = g.to(torch.float32)
    norms = torch.sqrt(torch.sum(g * g, dim=1))
    scale = 1.0 / torch.clamp(norms / clip, min=1.0)
    return torch.sum(g * scale[:, None], dim=0)
