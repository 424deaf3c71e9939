"""Plain PyTorch versions of the fused tick kernels.

Each mirrors, op for op, the reference's ``repro/kernels/tick_fused/
ref.py`` (the device tick's historical expressions): same products and
sums in the same order, same guards.  The wrappers in ``ops.py`` run
them on CPU tensors, and the kernels are checked against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import row_tiles


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


def server_apply_ref(v, due, dec, has_arr, *, ovf=None, ovf_hit=None,
                     reset=False, buf=None, flush=None, bc_v=None,
                     fired=None):
    """The server's step of a tick, the plain twin of the
    ``server_apply`` kernel: the same products and sums in the same
    order, the same in-place writes.

    v [D] server vector; due [A, D] the due ring slot (A == 1, or R
    sender-k strata under FedAsync); dec [A] decay weights; has_arr []
    bool.  With a far tier, ovf [Q, A, D] the overflow bucket and ovf_hit
    [Q] its due entry (at most one): the entry's row plus 0.0 (the
    reference's masked sum over the bucket, which turns -0.0 into +0.0;
    +0.0 when none is due) is added before the slot's row.  FedBuff: buf
    [D] banks the due row where ``has_arr`` and is applied and zeroed
    where ``flush``; otherwise ``v - sum_a dec[a] * due[a]`` where
    ``has_arr``, A == 1 scaling the single row and A > 1 adding
    ``0.0 + t_0 + t_1 + ...`` in ascending a.  In place: buf; with
    ``reset`` the slot and the due overflow row go to +0.0; bc_v [B, D]
    takes v' in the rows where fired [B].  Returns v', a new tensor."""
    A = due.shape[0]
    rows = due
    if ovf is not None:
        q = ovf_hit.to(torch.int32).argmax().reshape(1)   # the first due
        hit_rows = ovf.index_select(0, q)[0]
        rows = torch.where(ovf_hit.any(), hit_rows + 0.0, 0.0) + due
    if buf is not None:
        banked = torch.where(has_arr, buf + rows[0], buf)
        out = torch.where(flush, v - banked * dec[0], v)
        buf.copy_(torch.where(flush, 0.0, banked))
    else:
        contrib = rows[0] * dec[0]
        if A > 1:
            contrib = 0.0 + contrib
            for a in range(1, A):
                contrib = contrib + rows[a] * dec[a]
        out = torch.where(has_arr, v - contrib, v)
    if reset:
        due.zero_()
        if ovf is not None:
            ovf.masked_fill_(ovf_hit.reshape(-1, *[1] * (ovf.dim() - 1)),
                             0.0)
    if bc_v is not None:
        bc_v.copy_(torch.where(fired[:, None], out[None, :], bc_v))
    return out


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
    return (*_settle(sent, w, U, done, eta, dp_on), out)


def _settle(sent, w, U, done, eta, dp_on):
    """tick_scatter's w' and U'."""
    if dp_on:
        w_new = torch.where(done[:, None], w + eta[:, None] * (sent - U), w)
    else:
        w_new = w
    return w_new, torch.where(done[:, None], 0.0, sent)


# client rows of one tick_scatter tile (``csrc/tick_fused.cu``)
SCATTER_TILE_ROWS = 4


def tick_scatter_twin(sent, w, U, upd, wgt, any_g, done, eta, *, dp_on):
    """``tick_scatter_ref`` with the CUDA kernel's add order in the ring
    sums (``row_tiles.py``): on CPU tensors it gives the kernel's bits.

    Each product ``wgt[g, c] * sent[c, d]`` is rounded once, then added
    in blocks of consecutive clients (ascending, from the first) and the
    block sums by the finish pass's tree; ``upd + sum`` where ``any_g``.
    w' and U' are ``tick_scatter_ref``'s."""
    w_new, U_new = _settle(sent, w, U, done, eta, dp_on)
    C = sent.shape[0]
    if C == 0:
        return w_new, U_new, upd.clone()
    rb, _ = row_tiles.partition(C, SCATTER_TILE_ROWS)
    terms = wgt.T[:, :, None] * sent[:, None, :]            # [C, G, D]
    total = row_tiles.finish_tree(row_tiles.block_sums(terms, rb))
    return w_new, U_new, torch.where(any_g[:, None], upd + total, upd)


def tick_scatter_rows_twin(sent, w, U, wgt, done, eta, *, dp_on: bool,
                           rows_per_block: int, row_offset: int = 0,
                           carry=None):
    """tick_scatter's rows pass alone, with its add order: w' and U'
    (``tick_scatter_ref``'s) and the block partials [blocks, G, D] of
    the ring sums (``row_tiles.block_partials``) under a given rows per
    block, the first row at ``row_offset`` of its block, block 0 started
    from ``carry`` where given.  On the whole array with the partition's
    own rows per block and no offset, its partials are the ones
    ``tick_scatter_twin`` finishes."""
    w_new, U_new = _settle(sent, w, U, done, eta, dp_on)
    return w_new, U_new, row_tiles.block_partials(
        sent, wgt, rows_per_block, row_offset, carry)


def tick_scatter_finish_twin(partial, upd, any_g):
    """tick_scatter's finish pass alone: partial [blocks, G, D] ->
    [G, D], each row's block partials added by the finish tree.  The
    first ``upd.shape[0]`` rows start from ``upd`` and take the sum only
    where ``any_g`` (an untouched row stays bitwise); the rows past
    ``upd`` (all of them when ``upd`` is None) are the sum where
    ``any_g`` and 0.0 elsewhere.  ``any_g`` None is all true.  No host
    read: it runs under CUDA-graph capture."""
    nblk, G, D = partial.shape
    Gu = 0 if upd is None else upd.shape[0]
    base = partial.new_zeros((G, D))
    if Gu:
        base[:Gu] = upd
    if nblk == 0:
        return base
    total = row_tiles.finish_tree(partial)
    summed = torch.cat([upd + total[:Gu], total[Gu:]]) if Gu else total
    if any_g is None:
        return summed
    return torch.where(any_g.to(torch.bool)[:, None], summed, base)
