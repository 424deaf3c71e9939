"""Launcher of the logistic-regression client block
(``csrc/cohort_block.cu``).

Replaces no TPU kernel: the reference's ``CohortLogRegTask.block_body``
is a vmapped scan that XLA fuses.  One launch advances every client by
its own ``min(n[c], b)`` local SGD steps; see the source's note for the
design and its bound.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch import _build
from repro_torch.kernels.cohort_block.ref import inv_clip
from repro_torch.kernels.launches import LAUNCHES

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lib = None

#: the most features (D - 1) a launch takes: 32 lanes x ``kMaxKV`` (7)
#: groups of four of ``csrc/cohort_block.cu``, and a tail of 3
MAX_D = 4 * 32 * 7 + 3


def _block():
    global _lib
    if _lib is None:
        lib = _build.load("cohort_block")
        lib.logreg_block.argtypes = [_P] * 9 + [_I, _I, _I, _F, _I, _F, _P]
        lib.logreg_block.restype = _I
        _lib = lib
    return _lib


def logreg_block_kernel(w, U, idx, n, eta, X, y, *, l2: float, clip: float):
    """w, U [C, D] f32; idx [C, b] int64; n [C] int32; eta [C] f32;
    X [N, D - 1] f32; y [N] f32 -> new (w, U), each [C, D]."""
    C, D = w.shape
    b = idx.shape[1]
    dev = w.device
    if D - 1 > MAX_D:
        raise ValueError(f"cohort_logreg_block takes at most {MAX_D} "
                         f"features (D <= {MAX_D + 1}); got D = {D}")
    _build.need(w, "w", torch.float32, (C, D), dev)
    _build.need(U, "U", torch.float32, (C, D), dev)
    _build.need(idx, "idx", torch.int64, (C, b), dev)
    _build.need(n, "n", torch.int32, (C,), dev)
    _build.need(eta, "eta", torch.float32, (C,), dev)
    _build.need(X, "X", torch.float32, (X.shape[0], D - 1), dev)
    _build.need(y, "y", torch.float32, (X.shape[0],), dev)
    w_out, U_out = torch.empty_like(w), torch.empty_like(U)
    c_l2 = float(np.float32(0.5 * l2))    # the twin's f32 scalar
    _build.check(_block().logreg_block(
        w.data_ptr(), U.data_ptr(), idx.data_ptr(), n.data_ptr(),
        eta.data_ptr(), X.data_ptr(), y.data_ptr(), w_out.data_ptr(),
        U_out.data_ptr(), C, D, b, c_l2, int(l2 > 0.0), inv_clip(clip),
        _build.stream(dev)), "cohort_logreg_block")
    LAUNCHES["cohort_logreg_block"] += 1
    return w_out, U_out
