"""Launcher of the SSD scan kernels (``csrc/ssd_scan.cu``).

Replaces the reference's Pallas ``ssd_scan_kernel``
(``repro/kernels/ssd_scan/kernel.py``, ``_ssd_kernel``): the Mamba-2 SSD
chunked scan, chunk-parallel in four kernels (``C B^T`` once per (batch,
chunk); each chunk's own state; the states passed across chunks; each
chunk's outputs), the plain version's phases (``ref.py``).  It returns
the final state as well as ``y``.  See the source's note for the design.
``ssd_phase`` runs one of the four kernels on given workspaces: a test
aid, off the main path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I = ctypes.c_void_p, ctypes.c_int
_lib = None
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
F32 = torch.float32
# the phase mask of the C entry point
PHASES = {"cb": 1, "chunk_state": 2, "state_passing": 4, "chunk_scan": 8}
_ALL = 15


def _ss():
    global _lib
    if _lib is None:
        lib = _build.load("ssd_scan")
        lib.ssd_scan.argtypes = [_P] * 11 + [_I] * 8 + [_P]
        lib.ssd_scan.restype = _I
        _lib = lib
    return _lib


def _operands(x, dt, A, B, C, chunk, initial_state):
    """Validated kernel operands: (x, dt, A, B, C, h0, dims) with x, B, C
    in their common dtype (f32 or bf16, else f32), the rest f32, and dims
    (b, s, h, p, n, Q, nc)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dev = x.device
    if s < 1 or chunk < 1:
        raise ValueError(f"need s >= 1 and chunk >= 1, got {s}, {chunk}")
    cdt = x.dtype if x.dtype == B.dtype == C.dtype and x.dtype in _BF16 \
        else F32
    xk, Bk, Ck = (t.to(cdt).contiguous() for t in (x, B, C))
    dtk = dt.to(F32).contiguous()
    Ak = A.to(F32).contiguous()
    _build.need(xk, "x", cdt, (b, s, h, p), dev)
    _build.need(dtk, "dt", F32, (b, s, h), dev)
    _build.need(Ak, "A", F32, (h,), dev)
    _build.need(Bk, "B", cdt, (b, s, n), dev)
    _build.need(Ck, "C", cdt, (b, s, n), dev)
    h0 = None
    if initial_state is not None:
        h0 = initial_state.to(F32).contiguous()
        _build.need(h0, "initial_state", F32, (b, h, n, p), dev)
    Q = min(chunk, s)
    return xk, dtk, Ak, Bk, Ck, h0, (b, s, h, p, n, Q, -(-s // Q))


def _workspaces(dims, dev):
    """(cb (b,nc,Q,Q) f32, cum (b,nc,h,Q) f64, states (b,nc,h,n,p)
    f32)."""
    b, s, h, p, n, Q, nc = dims
    return (torch.empty((b, nc, Q, Q), dtype=F32, device=dev),
            torch.empty((b, nc, h, Q), dtype=torch.float64, device=dev),
            torch.empty((b, nc, h, n, p), dtype=F32, device=dev))


def _run(ops, ws, y, final, phases):
    xk, dtk, Ak, Bk, Ck, h0, dims = ops
    b, s, h, p, n, Q, _ = dims
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.check(_ss().ssd_scan(
        xk.data_ptr(), dtk.data_ptr(), Ak.data_ptr(), Bk.data_ptr(),
        Ck.data_ptr(), ptr(h0), y.data_ptr(), final.data_ptr(),
        *(t.data_ptr() for t in ws), _BF16[xk.dtype], b, s, h, p, n, Q,
        phases, _build.stream(xk.device)), "ssd_scan")


def ssd_scan_kernel(x, dt, A, B, C, chunk: int, initial_state=None):
    """x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n) -> (y (b,s,h,p) in
    x's dtype, final state (b,h,n,p) f32).  x, B and C run in their
    common dtype (f32 or bf16), else in f32; dt, A and the state in f32.
    The workspaces (about b·nc·h·n·p floats) come from the caller's
    device and stream."""
    ops = _operands(x, dt, A, B, C, chunk, initial_state)
    b, s, h, p, n, _, _ = ops[-1]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=ops[0].dtype, device=dev)
    final = torch.empty((b, h, n, p), dtype=F32, device=dev)
    _run(ops, _workspaces(ops[-1], dev), y, final, _ALL)
    LAUNCHES["ssd_scan"] += 1
    return y.to(x.dtype), final


def ssd_phase(name: str, x, dt, A, B, C, chunk: int, initial_state=None, *,
              cb=None, cum=None, states=None):
    """Run one of the four kernels (``PHASES``) on the card, on workspaces
    filled from the given tensors (what the earlier phases would have
    written: ``cb`` (b,nc,Q,Q) for chunk_scan, ``cum`` (b,nc,h,Q) for
    state_passing and chunk_scan, ``states`` (b,nc,h,n,p): the chunks' own
    states for state_passing, the states before each chunk for
    chunk_scan).  Returns ``dict(cb, cum, states, y, final)`` after it;
    what the phase did not write is uninitialised (cb: above the
    diagonal too).  A test aid: not counted."""
    ops = _operands(x, dt, A, B, C, chunk, initial_state)
    b, s, h, p, n, _, _ = ops[-1]
    dev = x.device
    ws = _workspaces(ops[-1], dev)
    for t, given in zip(ws, (cb, cum, states)):
        if given is not None:
            t.copy_(given)
    y = torch.empty((b, s, h, p), dtype=ops[0].dtype, device=dev)
    final = torch.empty((b, h, n, p), dtype=F32, device=dev)
    _run(ops, ws, y, final, PHASES[name])
    return dict(cb=ws[0], cum=ws[1], states=ws[2], y=y, final=final)
