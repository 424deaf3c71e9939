"""Launcher of the flash attention kernel (``csrc/flash_attention.cu``).

Replaces the reference's Pallas ``flash_attention``
(``repro/kernels/flash_attention/kernel.py``, ``_fa_kernel``):
online-softmax attention over ``q (B,S,H,hd)`` and ``k/v (B,S,KV,hd)``
with causal and sliding-window masks, logit softcap and GQA, f32 or
bf16 in, f32 accumulation, output in q's dtype.  f32 runs on the f32
pipes, bf16 on the tensor cores (wgmma; p rounded to bf16 before P V).
Ragged S is masked in the kernel, not padded.  See the source's note
for the design.  ``wgmma_probe`` runs the bf16 kernel's wgmma operand
forms on single tiles: a test aid, off the main path.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _fa():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.fa_max_head_dim.argtypes = []
        lib.fa_attention.argtypes = ([_P] * 4 + [_I] * 6
                                     + [_F, _I, _I, _F, _P])
        lib.fa_wgmma_probe.argtypes = [_P, _P, _P, _I, _P]
        for fn in (lib.fa_max_head_dim, lib.fa_attention,
                   lib.fa_wgmma_probe):
            fn.restype = _I
        _lib = lib
    return _lib


def flash_attention_kernel(q, k, v, *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None):
    """q (B,S,H,hd), k/v (B,S,KV,hd), all f32 or all bf16 -> (B,S,H,hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    dev = q.device
    if q.dtype not in _BF16:
        raise TypeError(f"q has dtype {q.dtype}, want float32 or bfloat16")
    _build.need(q, "q", q.dtype, (B, S, H, hd), dev)
    _build.need(k, "k", q.dtype, (B, S, KV, hd), dev)
    _build.need(v, "v", q.dtype, (B, S, KV, hd), dev)
    lib = _fa()
    if not 1 <= hd <= lib.fa_max_head_dim():
        raise ValueError(f"head_dim {hd} outside 1..{lib.fa_max_head_dim()}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0.0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    o = torch.empty_like(q)
    _build.check(lib.fa_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _BF16[q.dtype], B, S, H, KV, hd, 1.0 / math.sqrt(hd), int(causal),
        0 if window is None else int(window),
        0.0 if softcap is None else float(softcap), _build.stream(dev)),
        "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


# form -> (A shape, B shape, N): see fa_wgmma_probe in the source
PROBE_FORMS = {0: ((64, 256), (64, 256), 64),    # A smem . B K-major (Q K^T)
               1: ((64, 64), (64, 256), 256),    # A regs . B MN-major (P V)
               2: ((64, 64), (64, 64), 64),      # A regs . B K-major
               3: ((64, 64), (64, 256), 256)}    # A smem . B MN-major


def wgmma_probe(a, b, form: int):
    """One warpgroup's wgmma product of bf16 tiles on the card, as the bf16
    kernel lays them out: ``a @ b.T`` (B K-major) or ``a @ b`` (B
    MN-major), f32 (64, N).  Not counted: nothing on the main path calls
    it."""
    a_shape, b_shape, n = PROBE_FORMS[form]
    dev = a.device
    _build.need(a, "a", torch.bfloat16, a_shape, dev)
    _build.need(b, "b", torch.bfloat16, b_shape, dev)
    d = torch.empty((64, n), dtype=torch.float32, device=dev)
    _build.check(_fa().fa_wgmma_probe(a.data_ptr(), b.data_ptr(),
                                      d.data_ptr(), form, _build.stream(dev)),
                 "fa_wgmma_probe")
    return d
