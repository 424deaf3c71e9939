"""Plain PyTorch version of the cohort clip+noise+accumulate kernel,
op for op the reference's ``repro/kernels/cohort_dp/ref.py``."""
from __future__ import annotations

import torch


def cohort_clip_noise_ref(u, noise, weights, mask, *, clip: float,
                          noise_scale: float):
    """Batched round-completion DP over a client cohort.

    u:       (C, D) per-client round updates (flattened model dim)
    noise:   (C, D) standard-normal draws (unused when noise_scale <= 0)
    weights: (C,)   per-client aggregation weight (eta_i * send mask)
    mask:    (C,)   1.0 for clients finishing a round, 0.0 pass-through

    Returns (out, agg):
      out[c] = u[c] * min(1, clip/||u[c]||) + noise_scale * noise[c]
               for masked rows (clip <= 0 disables the row clip);
               pass-through rows return u[c] unchanged.
      agg[d] = sum_c weights[c] * out[c, d]
    """
    u = u.to(torch.float32)
    mask = mask.to(torch.float32)
    if clip > 0.0:
        norms = torch.sqrt(torch.sum(u * u, dim=1))
        scale = 1.0 / torch.clamp(norms / clip, min=1.0)
    else:
        scale = torch.ones_like(mask)
    scale = 1.0 + mask * (scale - 1.0)          # masked-out rows: scale 1
    out = u * scale[:, None]
    if noise_scale > 0.0:
        out = out + (noise_scale * mask)[:, None] * noise.to(torch.float32)
    agg = torch.sum(out * weights.to(torch.float32)[:, None], dim=0)
    return out, agg
