"""Dispatch for the cohort clip+noise kernels: by the tensors' device.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version.  ``cohort_clip_noise`` takes the noise as an
operand (the device engine's threefry normals, bit-compatible with the
reference's key chain); ``cohort_clip_noise_prng`` takes the tick's
noise key and generates the normals from its counter stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cohort_dp.kernel import (
    cohort_clip_noise_kernel, cohort_clip_noise_prng_kernel)
from repro_torch.kernels.cohort_dp.ref import (cohort_clip_noise_prng_ref,
                                               cohort_clip_noise_ref)
from repro_torch.kernels.tick_fused.ops import on_cuda


def cohort_clip_noise(u, noise, weights, mask, *, clip: float = 0.0,
                      noise_scale: float = 0.0, with_agg: bool = True):
    """u: (C, D) round updates -> (noised rows (C, D), weighted agg (D,)).

    clip <= 0 disables the per-row norm clip; noise_scale is the std-dev
    multiplier on the standard-normal ``noise`` (protocol: dp_clip *
    dp_sigma), which may be None when noise_scale <= 0.  with_agg=False
    skips the weighted sum: agg is None."""
    if not on_cuda(u):
        return cohort_clip_noise_ref(u, noise, weights, mask, clip=clip,
                                     noise_scale=noise_scale,
                                     with_agg=with_agg)
    return cohort_clip_noise_kernel(
        u.contiguous(), None if noise_scale <= 0.0 else noise.contiguous(),
        weights.to(torch.float32), mask.to(torch.float32), clip=clip,
        noise_scale=noise_scale, with_agg=with_agg)


def cohort_clip_noise_prng(u, key, weights, mask, *, clip: float = 0.0,
                           noise_scale: float = 0.0, with_agg: bool = True,
                           row_offset: int = 0):
    """``cohort_clip_noise`` with the normals generated from ``key`` (one
    ``[2]`` key on the CPU: its words become kernel scalars) — on the
    card inside the kernel, on the CPU by the plain version, which
    reproduces the kernel's stream.  ``row_offset``: u's row 0 is that
    row of the draw (a rank's rows of the client axis take the normals
    of the whole draw's matching rows)."""
    if not on_cuda(u):
        return cohort_clip_noise_prng_ref(u, key, weights, mask, clip=clip,
                                          noise_scale=noise_scale,
                                          with_agg=with_agg,
                                          row_offset=row_offset)
    return cohort_clip_noise_prng_kernel(
        u.contiguous(), key, weights.to(torch.float32),
        mask.to(torch.float32), clip=clip, noise_scale=noise_scale,
        with_agg=with_agg, row_offset=row_offset)
