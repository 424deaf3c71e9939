"""Launcher of the clip-accumulate kernel (``csrc/dp_clip.cu``).

Replaces the reference's Pallas ``clip_accumulate_kernel``
(``repro/kernels/dp_clip/kernel.py``: ``_sqsum_kernel`` and
``_scale_sum_kernel``): ``out[d] = sum_n G[n, d] min(1, clip/||G[n]||)``
over per-example gradients, f32 or bf16 in, f32 out.  See the source's
note for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _dc():
    global _lib
    if _lib is None:
        lib = _build.load("dp_clip")
        lib.dc_blocks.argtypes = [_I, _I]
        lib.dc_clip_accumulate.argtypes = [_P, _I, _P, _P, _P, _I, _I, _F,
                                           _P]
        for fn in (lib.dc_blocks, lib.dc_clip_accumulate):
            fn.restype = _I
        _lib = lib
    return _lib


def clip_accumulate_kernel(g, clip: float):
    """g (N, D) f32 or bf16 -> (D,) f32."""
    N, D = g.shape
    dev = g.device
    if g.dtype not in _BF16:
        raise TypeError(f"g has dtype {g.dtype}, want float32 or bfloat16")
    _build.need(g, "g", g.dtype, (N, D), dev)
    if not clip > 0.0:
        raise ValueError(f"clip must be > 0, got {clip}")
    lib = _dc()
    bf16 = _BF16[g.dtype]
    out = torch.empty((D,), dtype=torch.float32, device=dev)
    partial = torch.empty((lib.dc_blocks(N, bf16), D), dtype=torch.float32,
                          device=dev)
    scale = torch.empty((N,), dtype=torch.float32, device=dev)
    _build.check(lib.dc_clip_accumulate(
        g.data_ptr(), bf16, out.data_ptr(), partial.data_ptr(),
        scale.data_ptr(), N, D, float(clip), _build.stream(dev)),
        "clip_accumulate")
    LAUNCHES["clip_accumulate"] += 1
    return out
