"""Launcher of the cohort clip+noise kernel (``csrc/cohort_dp.cu``).

Replaces the reference's Pallas ``_row_sqsum`` + ``cohort_clip_noise_kernel``
(``repro/kernels/cohort_dp/kernel.py``, operand-noise path): per-row
clip, noise from an operand, weighted sum over clients.  A memory-bound
f32 stream over [C, D]; see the source's note for the design.  The
in-kernel-RNG variant (``cohort_clip_noise_prng_kernel``) is ROADMAP
Queue 2 item 5.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None


def _dp():
    global _lib
    if _lib is None:
        lib = _build.load("cohort_dp")
        lib.dp_blocks.argtypes = [_I]
        lib.dp_clip_noise.argtypes = [_P] * 7 + [_I, _I, _F, _F, _P]
        lib.dp_blocks.restype = _I
        lib.dp_clip_noise.restype = _I
        _lib = lib
    return _lib


def cohort_clip_noise_kernel(u, noise, weights, mask, *, clip: float,
                             noise_scale: float):
    """u [C, D] f32; noise [C, D] f32 (None when noise_scale <= 0);
    weights, mask [C] f32 -> (out [C, D], agg [D])."""
    C, D = u.shape
    dev = u.device
    _build.need(u, "u", torch.float32, (C, D), dev)
    if noise_scale > 0.0:
        _build.need(noise, "noise", torch.float32, (C, D), dev)
    _build.need(weights, "weights", torch.float32, (C,), dev)
    _build.need(mask, "mask", torch.float32, (C,), dev)
    lib = _dp()
    out = torch.empty_like(u)
    agg = torch.empty((D,), dtype=torch.float32, device=dev)
    partial = torch.empty((lib.dp_blocks(C), D), dtype=torch.float32,
                          device=dev)
    _build.check(lib.dp_clip_noise(
        u.data_ptr(), noise.data_ptr() if noise_scale > 0.0 else None,
        mask.data_ptr(), weights.data_ptr(), out.data_ptr(), agg.data_ptr(),
        partial.data_ptr(), C, D, float(clip), float(noise_scale),
        _build.stream(dev)), "cohort_clip_noise")
    LAUNCHES["cohort_clip_noise"] += 1
    return out, agg
