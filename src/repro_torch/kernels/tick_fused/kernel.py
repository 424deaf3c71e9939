"""Launchers of the fused tick kernels (``csrc/tick_fused.cu``).

Replaces the Pallas kernels of the reference's
``repro/kernels/tick_fused/kernel.py``:

* ``server_apply_kernel``  <- ``_bucket_apply_kernel``
  (``bucket_apply_kernel``), redesigned as the server's whole step of a
  tick; ``bucket_apply_kernel`` is the same kernel with only the apply
* ``tick_deliver_kernel``  <- ``_tick_deliver_kernel`` (``tick_deliver_kernel``)
* ``tick_scatter_kernel``  <- ``_tick_scatter_kernel`` (``tick_scatter_kernel``)

All three are memory-bound f32 streams (see the source's note for the
design).  Each launcher checks device, dtype, shape and contiguity,
allocates its outputs, launches on PyTorch's current stream without
synchronising, raises on a launch error, and counts the launch in
``repro_torch.kernels.launches.LAUNCHES`` (the server step under
``"bucket_apply"``, the reference's name for it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_lib = None


def _tf():
    global _lib
    if _lib is None:
        lib = _build.load("tick_fused")
        lib.tf_bucket_apply.argtypes = [_P] * 5 + [_I, _L, _P]
        lib.tf_server_apply.argtypes = [_P] * 11 + [_I] * 3 + [_L, _I, _P]
        lib.tf_tick_deliver.argtypes = [_P] * 7 + [_I, _I, _P]
        lib.tf_scatter_blocks.argtypes = [_I]
        lib.tf_tick_scatter.argtypes = [_P] * 12 + [_I] * 4 + [_P]
        for fn in (lib.tf_bucket_apply, lib.tf_server_apply,
                   lib.tf_tick_deliver,
                   lib.tf_scatter_blocks, lib.tf_tick_scatter):
            fn.restype = _I
        _lib = lib
    return _lib


def _flag(t, name, dev) -> None:
    """A one-element bool tensor on ``dev``, read by the kernel there."""
    if t.device != dev or t.dtype != torch.bool or t.numel() != 1:
        raise ValueError(f"{name} must be one bool on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def bucket_apply_kernel(v, rows, dec, flag):
    """v [D] f32, rows [A, D] f32, dec [A] f32, flag one bool -> [D]."""
    A, D = rows.shape
    dev = v.device
    _build.need(v, "v", torch.float32, (D,), dev)
    _build.need(rows, "rows", torch.float32, (A, D), dev)
    _build.need(dec, "dec", torch.float32, (A,), dev)
    _flag(flag, "flag", dev)
    if A < 1:
        raise ValueError("need at least one bucket row")
    out = torch.empty_like(v)
    _build.check(_tf().tf_bucket_apply(
        v.data_ptr(), rows.data_ptr(), dec.data_ptr(), flag.data_ptr(),
        out.data_ptr(), A, D, _build.stream(dev)), "bucket_apply")
    LAUNCHES["bucket_apply"] += 1
    return out


def server_apply_kernel(v, due, dec, has_arr, *, ovf=None, ovf_hit=None,
                        reset=False, buf=None, flush=None, bc_v=None,
                        fired=None):
    """The server's step of a tick in one launch (``server_apply``'s
    operands; the in-place ones must be contiguous: a copy would take the
    writes)."""
    A, D = due.shape
    dev = v.device
    _build.need(v, "v", torch.float32, (D,), dev)
    _build.need(due, "due", torch.float32, (A, D), dev)
    _build.need(dec, "dec", torch.float32, (A,), dev)
    _flag(has_arr, "has_arr", dev)
    if A < 1:
        raise ValueError("need at least one bucket row")
    Q = B = 0
    if ovf is not None:
        Q = ovf.shape[0]
        _build.need(ovf, "ovf", torch.float32, (Q, A, D), dev)
        _build.need(ovf_hit, "ovf_hit", torch.bool, (Q,), dev)
    if buf is not None:
        if A != 1:
            raise ValueError("a banked buffer takes one bucket row")
        _build.need(buf, "buf", torch.float32, (D,), dev)
        _flag(flush, "flush", dev)
    if bc_v is not None:
        B = bc_v.shape[0]
        _build.need(bc_v, "bc_v", torch.float32, (B, D), dev)
        _build.need(fired, "fired", torch.bool, (B,), dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty_like(v)
    _build.check(_tf().tf_server_apply(
        v.data_ptr(), due.data_ptr(), dec.data_ptr(), has_arr.data_ptr(),
        ptr(ovf), ptr(ovf_hit if ovf is not None else None), ptr(buf),
        ptr(flush if buf is not None else None), ptr(bc_v),
        ptr(fired if bc_v is not None else None), out.data_ptr(), A, Q, B,
        D, int(bool(reset)), _build.stream(dev)), "server_apply")
    LAUNCHES["bucket_apply"] += 1
    return out


def tick_deliver_kernel(w, U, bc_v, best, take, eta):
    """w, U [C, D] f32; bc_v [B, D] f32; best [C] int64 in [0, B);
    take [C] bool; eta [C] f32 -> [C, D]."""
    C, D = w.shape
    B = bc_v.shape[0]
    dev = w.device
    _build.need(w, "w", torch.float32, (C, D), dev)
    _build.need(U, "U", torch.float32, (C, D), dev)
    _build.need(bc_v, "bc_v", torch.float32, (B, D), dev)
    _build.need(best, "best", torch.int64, (C,), dev)
    _build.need(take, "take", torch.bool, (C,), dev)
    _build.need(eta, "eta", torch.float32, (C,), dev)
    out = torch.empty_like(w)
    _build.check(_tf().tf_tick_deliver(
        w.data_ptr(), U.data_ptr(), bc_v.data_ptr(), best.data_ptr(),
        take.data_ptr(), eta.data_ptr(), out.data_ptr(), C, D,
        _build.stream(dev)), "tick_deliver")
    LAUNCHES["tick_deliver"] += 1
    return out


def tick_scatter_kernel(sent, w, U, upd, wgt, any_g, done, eta, *,
                        dp_on: bool):
    """sent, w, U [C, D] f32; upd [G, D] f32; wgt [G, C] f32; any_g [G]
    bool; done [C] bool; eta [C] f32 -> (w', U', upd')."""
    C, D = sent.shape
    G = upd.shape[0]
    dev = sent.device
    for name, t in (("sent", sent), ("w", w), ("U", U)):
        _build.need(t, name, torch.float32, (C, D), dev)
    _build.need(upd, "upd", torch.float32, (G, D), dev)
    _build.need(wgt, "wgt", torch.float32, (G, C), dev)
    _build.need(any_g, "any_g", torch.bool, (G,), dev)
    _build.need(done, "done", torch.bool, (C,), dev)
    _build.need(eta, "eta", torch.float32, (C,), dev)
    lib = _tf()
    w_out = torch.empty_like(w)
    u_out = torch.empty_like(U)
    upd_out = torch.empty_like(upd)
    partial = torch.empty((lib.tf_scatter_blocks(C), G, D),
                          dtype=torch.float32, device=dev)
    _build.check(lib.tf_tick_scatter(
        sent.data_ptr(), w.data_ptr(), U.data_ptr(), upd.data_ptr(),
        wgt.data_ptr(), any_g.data_ptr(), done.data_ptr(), eta.data_ptr(),
        w_out.data_ptr(), u_out.data_ptr(), upd_out.data_ptr(),
        partial.data_ptr(), C, D, G, int(bool(dp_on)), _build.stream(dev)),
        "tick_scatter")
    LAUNCHES["tick_scatter"] += 1
    return w_out, u_out, upd_out
