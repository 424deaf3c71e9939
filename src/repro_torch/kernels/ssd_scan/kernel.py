"""Launcher of the SSD scan kernel (``csrc/ssd_scan.cu``).

Replaces the reference's Pallas ``ssd_scan_kernel``
(``repro/kernels/ssd_scan/kernel.py``, ``_ssd_kernel``): the Mamba-2 SSD
chunked scan, one block per (batch, head) walking the chunks in order
with the (n, p) state in shared memory.  It returns the final state as
well as ``y``.  See the source's note for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def _ss():
    global _lib
    if _lib is None:
        lib = _build.load("ssd_scan")
        lib.ssd_threads.argtypes = []
        lib.ssd_threads.restype = _I
        lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.ssd_scan.restype = _I
        _lib = lib
    return _lib


def ssd_scan_kernel(x, dt, A, B, C, chunk: int, initial_state=None):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n) -> (y (b,s,h,p) in
    x's dtype, final state (b,h,n,p) f32).  x, B and C run in their
    common dtype (f32 or bf16), else in f32; dt, A and the state in f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if s < 1 or chunk < 1:
        raise ValueError(f"need s >= 1 and chunk >= 1, got {s}, {chunk}")
    lib = _ss()
    if lib.ssd_threads() % p:
        raise ValueError(f"head_dim {p} must divide {lib.ssd_threads()}")
    cdt = x.dtype if x.dtype == B.dtype == C.dtype and x.dtype in _BF16 \
        else torch.float32
    xk, Bk, Ck = (t.to(cdt).contiguous() for t in (x, B, C))
    dtk = dt.to(torch.float32).contiguous()
    Ak = A.to(torch.float32).contiguous()
    _build.need(xk, "x", cdt, (b, s, h, p), dev)
    _build.need(dtk, "dt", torch.float32, (b, s, h), dev)
    _build.need(Ak, "A", torch.float32, (h,), dev)
    _build.need(Bk, "B", cdt, (b, s, n), dev)
    _build.need(Ck, "C", cdt, (b, s, n), dev)
    h0 = None
    if initial_state is not None:
        h0 = initial_state.to(torch.float32).contiguous()
        _build.need(h0, "initial_state", torch.float32, (b, h, n, p), dev)
    y = torch.empty((b, s, h, p), dtype=cdt, device=dev)
    final = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
    _build.check(lib.ssd_scan(
        xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        final.data_ptr(), _BF16[cdt], b, s, h, p, n, min(chunk, s),
        _build.stream(dev)), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y.to(x.dtype), final
