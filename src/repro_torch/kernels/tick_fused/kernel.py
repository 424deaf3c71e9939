"""Launchers of the fused tick kernels (``csrc/tick_fused.cu``).

Replaces the Pallas kernels of the reference's
``repro/kernels/tick_fused/kernel.py``:

* ``server_apply_kernel``  <- ``_bucket_apply_kernel``
  (``bucket_apply_kernel``), redesigned as the server's whole step of a
  tick; ``bucket_apply_kernel`` is the same kernel with only the apply
* ``tick_deliver_kernel``  <- ``_tick_deliver_kernel`` (``tick_deliver_kernel``)
* ``tick_scatter_kernel``  <- ``_tick_scatter_kernel``
  (``tick_scatter_kernel``); its two passes are also entry points of their
  own,
  ``tick_scatter_rows_kernel`` (a given rows per block, row offset and
  start carry, partials out) and ``tick_scatter_finish_kernel`` (the
  tree over given partials): the cohort engines' route, so the partials
  of a client axis cut over ranks can be gathered between them

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
        lib.tf_scatter_rows.argtypes = [_P] * 10 + [_I] * 7 + [_P]
        lib.tf_scatter_finish.argtypes = [_P, _P, _I, _P, _P] + [_I] * 3 + [_P]
        for fn in (lib.tf_bucket_apply, lib.tf_server_apply,
                   lib.tf_tick_deliver, lib.tf_scatter_blocks,
                   lib.tf_tick_scatter,
                   lib.tf_scatter_rows, lib.tf_scatter_finish):
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


def tick_scatter_rows_kernel(sent, w, U, wgt, done, eta, *, dp_on: bool,
                             rows_per_block: int, row_offset: int = 0,
                             carry=None, out=None):
    """The rows pass alone: sent, w, U [n, D] f32 (row slices of larger
    blocks are fine: rows are contiguous); wgt [G, n] f32 with unit
    column stride (a column slice of a [G, C] matrix is fine); done [n]
    bool; eta [n] f32; carry [G, D] f32 or None -> (w', U', partial
    [blocks, G, D]).  ``out`` = (w_out, u_out) [n, D] to write w' and U'
    into (views of larger blocks), else new tensors."""
    n, D = sent.shape
    G = wgt.shape[0]
    dev = sent.device
    rb, off = int(rows_per_block), int(row_offset)
    if not 0 <= off < rb:
        raise ValueError(f"row offset {off} outside [0, {rb})")
    for name, t in (("sent", sent), ("w", w), ("U", U)):
        _build.need(t, name, torch.float32, (n, D), dev)
    if (tuple(wgt.shape) != (G, n) or wgt.dtype != torch.float32
            or wgt.device != dev or (n > 1 and wgt.stride(1) != 1)):
        raise ValueError(f"wgt must be [{G}, {n}] f32 on {dev} with unit "
                         f"column stride, got {wgt.dtype} "
                         f"{tuple(wgt.shape)} {wgt.stride()}")
    _build.need(done, "done", torch.bool, (n,), dev)
    _build.need(eta, "eta", torch.float32, (n,), dev)
    if carry is not None:
        _build.need(carry, "carry", torch.float32, (G, D), dev)
    if out is None:
        w_out, u_out = torch.empty_like(w), torch.empty_like(U)
    else:
        w_out, u_out = out
        _build.need(w_out, "w_out", torch.float32, (n, D), dev)
        _build.need(u_out, "u_out", torch.float32, (n, D), dev)
    partial = torch.empty((-(-(off + n) // rb), G, D), dtype=torch.float32,
                          device=dev)
    _build.check(_tf().tf_scatter_rows(
        sent.data_ptr(), w.data_ptr(), U.data_ptr(), wgt.data_ptr(),
        done.data_ptr(), eta.data_ptr(), w_out.data_ptr(), u_out.data_ptr(),
        partial.data_ptr(), None if carry is None else carry.data_ptr(), n,
        D, G, wgt.stride(0), rb, off, int(bool(dp_on)), _build.stream(dev)),
        "tick_scatter_rows")
    LAUNCHES["tick_scatter_rows"] += 1
    return w_out, u_out, partial


def tick_scatter_finish_kernel(partial, upd, any_g):
    """The finish pass alone: partial [blocks, G, D] f32; upd [Gu, D] f32
    (Gu <= G) or None; any_g [G] bool or None -> [G, D]."""
    nblk, G, D = partial.shape
    dev = partial.device
    _build.need(partial, "partial", torch.float32, (nblk, G, D), dev)
    Gu = 0
    if upd is not None:
        Gu = upd.shape[0]
        if Gu > G:
            raise ValueError(f"upd has {Gu} rows, more than G = {G}")
        _build.need(upd, "upd", torch.float32, (Gu, D), dev)
    if any_g is not None:
        _build.need(any_g, "any_g", torch.bool, (G,), dev)
    out = torch.empty((G, D), dtype=torch.float32, device=dev)
    _build.check(_tf().tf_scatter_finish(
        partial.data_ptr(), None if upd is None else upd.data_ptr(), Gu,
        None if any_g is None else any_g.data_ptr(), out.data_ptr(), nblk,
        G, D, _build.stream(dev)), "tick_scatter_finish")
    LAUNCHES["tick_scatter_finish"] += 1
    return out

