"""Plain PyTorch versions of the fused tick kernels.

Each mirrors, op for op, the reference's ``repro/kernels/tick_fused/
ref.py`` (the device tick's historical expressions): same products and
sums in the same order, same guards.  The wrappers in ``ops.py`` run
them on CPU tensors, and the kernels are checked against them on the
card.
"""
from __future__ import annotations

import torch


def bucket_apply_ref(v, rows, dec, flag):
    """v [D] server vector, rows [A, D] bucket rows, dec [A] decay
    weights, flag [] bool -> ``v - sum_a dec[a] * rows[a]`` where set.

    A == 1 scales the single row (``rows[0] * dec[0]``): a sum over a
    size-1 axis would compute ``0.0 + x`` and flip a ``-0.0`` row."""
    if rows.shape[0] == 1:
        contrib = rows[0] * dec[0]
    else:
        contrib = torch.sum(rows * dec[:, None], dim=0)
    return torch.where(flag, v - contrib, v)


def tick_deliver_ref(w, U, bc_v, best, take, eta):
    """w, U [C, D]; bc_v [B, D]; best [C] ring index of the freshest
    eligible broadcast; take [C] bool; eta [C] round stepsizes ->
    ``bc_v[best] - eta * U`` on taking rows, ``w`` elsewhere."""
    return torch.where(take[:, None], bc_v[best] - eta[:, None] * U, w)


def tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, *, dp_on):
    """Scatter finished rounds into the update ring; settle w and U.

    sent, w, U [C, D]; upd [G, D] ring rows; wgt [G, C] per-row scatter
    weights (``eta * in_g``); any_g [G] bool; done [C] bool; eta [C].
    Each ring row adds its full-client-axis weighted sum only when
    ``any_g`` (untouched rows stay bitwise, not ``old + 0``); with
    ``dp_on`` finished rows take ``w + eta * (sent - U)``; ``U`` resets to
    0 on finished rows and becomes ``sent`` elsewhere.
    """
    rows = []
    for g in range(upd.shape[0]):
        vec = torch.sum(sent * wgt[g][:, None], dim=0)
        rows.append(torch.where(any_g[g], upd[g] + vec, upd[g]))
    out = torch.stack(rows) if rows else upd.clone()
    if dp_on:
        w_new = torch.where(done[:, None], w + eta[:, None] * (sent - U), w)
    else:
        w_new = w
    U_new = torch.where(done[:, None], 0.0, sent)
    return w_new, U_new, out
