"""Dispatch for the logistic-regression client block: by the tensors'
device.  A CUDA tensor goes to the CUDA kernel (one launch) or the call
raises; a CPU tensor goes to the plain twin."""
from __future__ import annotations

import torch

from repro_torch.kernels.cohort_block.kernel import logreg_block_kernel
from repro_torch.kernels.cohort_block.ref import logreg_block_ref
from repro_torch.kernels.tick_fused.ops import on_cuda


def logreg_block(w, U, idx, n, eta, X, y, *, l2: float, clip: float):
    """Every client's ``min(n[c], b)`` local SGD steps of one block tick:
    w, U [C, D]; idx [C, b] sampled rows of X [N, D - 1]; y [N]; n [C]
    steps to take; eta [C] step sizes -> new (w, U).  ``clip > 0`` clips
    each step's (w, b) gradient pair to that norm; ``l2`` the ridge term
    on ``w``."""
    if not on_cuda(w):
        return logreg_block_ref(w, U, idx, n, eta, X, y, l2=l2, clip=clip)
    return logreg_block_kernel(
        w.contiguous(), U.contiguous(), idx.contiguous(),
        n.to(torch.int32).contiguous(), eta.to(torch.float32).contiguous(),
        X.contiguous(), y.to(torch.float32).contiguous(), l2=l2, clip=clip)
