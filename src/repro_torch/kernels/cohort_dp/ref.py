"""Plain PyTorch versions of the cohort clip+noise+accumulate kernels:
the operand-noise one op for op the reference's
``repro/kernels/cohort_dp/ref.py``, and the in-kernel-noise one with the
CUDA kernel's counter stream and Box-Muller."""
from __future__ import annotations

import torch

from repro_torch import prng

# f32 constants of the TPU kernel's Box-Muller (kernel.py:80-82)
_TWO_M24 = 2.0 ** -24
_TWO_M25 = 2.0 ** -25
_TWO_PI_F32 = 6.2831854820251465          # float32(2 * pi)


def cohort_clip_noise_ref(u, noise, weights, mask, *, clip: float,
                          noise_scale: float, with_agg: bool = True):
    """Batched round-completion DP over a client cohort.

    u:       (C, D) per-client round updates (flattened model dim)
    noise:   (C, D) standard-normal draws (unused when noise_scale <= 0)
    weights: (C,)   per-client aggregation weight (eta_i * send mask)
    mask:    (C,)   1.0 for clients finishing a round, 0.0 pass-through

    Returns (out, agg):
      out[c] = u[c] * min(1, clip/||u[c]||) + noise_scale * noise[c]
               for masked rows (clip <= 0 disables the row clip);
               pass-through rows return u[c] unchanged.
      agg[d] = sum_c weights[c] * out[c, d]   (None unless with_agg)
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
    if not with_agg:
        return out, None
    agg = torch.sum(out * weights.to(torch.float32)[:, None], dim=0)
    return out, agg


def counter_normals(key, C: int, D: int, device=None, *,
                    start: int = 0) -> torch.Tensor:
    """[C, D] standard normals of the in-kernel stream: threefry2x32 of
    ``key`` on each element's flat index ``start + c * D + d`` (x0 -> b1,
    x1 -> b2; 64-bit, as the kernel's), then Box-Muller on the top 24
    bits of each word, in f32: ``u1 = (b1 >> 8) 2^-24 + 2^-25``,
    ``u2 = (b2 >> 8) 2^-24``, ``n = sqrt(-2 log u1) cos(2 pi u2)``.
    ``start`` draws a piece of a larger block (a slab of one row)."""
    b1, b2 = prng.counter_words(key, C * D, device=device, start=start)
    u1 = (b1 >> 8).to(torch.float32) * _TWO_M24 + _TWO_M25
    u2 = (b2 >> 8).to(torch.float32) * _TWO_M24
    n = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)
    return n.reshape(C, D)


def cohort_clip_noise_prng_ref(u, key, weights, mask, *, clip: float,
                               noise_scale: float, with_agg: bool = True,
                               row_offset: int = 0):
    """``cohort_clip_noise_ref`` with the normals of ``counter_normals``
    (drawn only when ``noise_scale > 0``); ``key`` is one CPU key.  u's
    row 0 is row ``row_offset`` of the draw (a rank's rows of the whole
    client axis)."""
    C, D = u.shape
    noise = (counter_normals(key, C, D, device=u.device,
                             start=int(row_offset) * D)
             if noise_scale > 0.0 else None)
    return cohort_clip_noise_ref(u, noise, weights, mask, clip=clip,
                                 noise_scale=noise_scale, with_agg=with_agg)
