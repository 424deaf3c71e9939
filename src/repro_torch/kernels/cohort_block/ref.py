"""Plain PyTorch twin of ``cohort_logreg_block`` (``csrc/cohort_block.cu``).

The kernel's f32 arithmetic step by step (``models.logreg.per_example_grad``'s
formula and the reference's ``clip_tree`` of each client's (w, b) pair),
with the kernel's own add order for its two row sums (``lane_sum``): on
CUDA tensors it gives the kernel's bits, and the card tests hold the
kernel to it bitwise.  Only the steps ``j < n[c]`` run: a client past its
``n[c]`` keeps its rows' bits (``torch.where``, not a gradient times 0).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LANES = 32


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of ``v`` [C, m] in the kernel's order, which is PyTorch's
    own f32 row sum on the card for a contiguous row whose length is a
    multiple of 4 and at least 128.  The row is read as groups of four
    (then ``m % 4`` tail elements); lane ``l`` of a warp holds groups
    ``l, l + 32, ...`` and tail element ``4 (m // 4) + l``, and sums them
    into four accumulators from +0.0, one per place in a group, in
    ascending group order, the tail element into the first; the four meet
    as ((a0 + a1) + a2) + a3, then the lanes in a shuffle tree of offsets
    16, 8, 4, 2, 1 into lane 0 (here as halvings, which add the same
    pairs).  An accumulator that starts at +0.0 is never -0.0, so the
    +0.0 padding adds nothing."""
    C, m = v.shape
    q, t = divmod(m, 4)
    KV = max(1, -(-q // LANES))
    groups = F.pad(v[:, :4 * q], (0, 4 * KV * LANES - 4 * q)).view(
        C, KV, LANES, 4)
    acc = torch.zeros(C, LANES, 4, dtype=v.dtype, device=v.device)
    for k in range(KV):
        acc = acc + groups[:, k]
    acc[:, :t, 0] = acc[:, :t, 0] + v[:, 4 * q:]
    s = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
    width = LANES // 2
    while width:
        s = s[:, :width] + s[:, width:2 * width]
        width //= 2
    return s[:, 0]


def inv_clip(clip: float) -> float:
    """The clip's reciprocal taken in double and rounded to f32, as
    PyTorch on the card divides an f32 tensor by a Python number (0 when
    ``clip <= 0``: no clip)."""
    return float(np.float32(1.0 / clip)) if clip > 0.0 else 0.0


def clip_scale(norm: torch.Tensor, clip: float) -> torch.Tensor:
    """``1 / max(norm / clip, 1)``, the division taken as the card takes
    it (``norm * inv_clip(clip)``) on either device."""
    return 1.0 / torch.clamp(norm * inv_clip(clip), min=1.0)


def logreg_block_ref(w, U, idx, n, eta, X, y, *, l2: float, clip: float):
    """Advance every client ``c`` by ``min(n[c], b)`` single-sample SGD
    steps: w, U [C, D] f32 (``w`` then ``b``, D = d + 1); idx [C, b]
    rows of X [N, d]; y [N]; n [C] int; eta [C] f32 -> new (w, U)."""
    d = w.shape[1] - 1
    pw, pb = w[:, :d], w[:, d]
    uw, ub = U[:, :d], U[:, d]
    eta_w = eta[:, None]
    steps = min(int(n.max()) if n.numel() else 0, idx.shape[1])
    for j in range(steps):
        act = j < n
        x, yj = X[idx[:, j]], y[idx[:, j]]
        # per_example_grad: clamp's balanced tie, log1p' then exp', the
        # sign of abs', the l2 term as f32(0.5 l2) (2 w)
        z = lane_sum(x * pw) + pb
        bal = torch.where(z > 0.0, 1.0, torch.where(z == 0.0, 0.5, 0.0))
        e = torch.exp(-torch.abs(z))
        t = (1.0 / (e + 1.0)) * e
        gb = (torch.where(z >= 0.0, -t, t) - yj) + bal
        gw = x * gb[:, None]
        if l2 > 0.0:
            gw = gw + (0.5 * l2) * (2.0 * pw)
        if clip > 0.0:
            # one norm over the pair, b's square first
            s = clip_scale(torch.sqrt(gb * gb + lane_sum(gw * gw)), clip)
            gw, gb = gw * s[:, None], gb * s
        act_w = act[:, None]
        uw = torch.where(act_w, uw + gw, uw)
        ub = torch.where(act, ub + gb, ub)
        pw = torch.where(act_w, pw - eta_w * gw, pw)
        pb = torch.where(act, pb - eta * gb, pb)
    return (torch.cat([pw, pb[:, None]], dim=1),
            torch.cat([uw, ub[:, None]], dim=1))
