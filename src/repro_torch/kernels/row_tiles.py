"""The add order of ``csrc/row_tiles.cuh`` in plain PyTorch.

The row-streaming kernels (``tick_scatter``, ``clip_accumulate``) sum
over rows in a fixed order: rows split into blocks (``partition``), each
block's rows added in ascending order from its first term
(``block_sums``), then the block partials combined by the finish pass's
tree (``finish_tree``).  These functions repeat that order with torch
ops on CPU tensors, each f32 add rounded as ``__fadd_rn`` rounds it, so
the kernels' order-exact twins in ``ref.py`` give their bits.  The
constants are ``row_tiles.cuh``'s.
"""
from __future__ import annotations

import torch

MAX_BLOCKS = 264
LEAVES = 16


def partition(n: int, tile_rows: int):
    """(rows per block, blocks) of n rows in tiles of ``tile_rows``."""
    ntiles = -(-n // tile_rows)
    per = -(-ntiles // MAX_BLOCKS) if ntiles > MAX_BLOCKS else 1
    rb = tile_rows * per
    return rb, -(-n // rb)


def block_sums(terms: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """terms [n, ...] -> [blocks, ...]: each block's rows added in
    ascending order, starting from its first row."""
    acc = terms[0::rows_per_block].clone()
    for i in range(1, rows_per_block):
        rows = terms[i::rows_per_block]      # only the last block is short
        acc[:rows.shape[0]] = acc[:rows.shape[0]] + rows
    return acc


def block_partials(sent: torch.Tensor, wgt: torch.Tensor,
                   rows_per_block: int, row_offset: int = 0,
                   carry=None) -> torch.Tensor:
    """The rows pass's partials of ``sum_c wgt[g, c] * sent[c, d]``:
    sent [n, D], wgt [G, n] -> [blocks, G, D].

    Row 0 sits at position ``row_offset`` of its block (the rows of a
    larger array cut at a row that is not a block's first), so block b
    holds rows ``[b * rb - row_offset, (b + 1) * rb - row_offset)``;
    each product is rounded once and each block's rows added in
    ascending order from its first, block 0 from ``carry`` [G, D] where
    given (the running sum of its rows before row 0).  The products are
    taken one row position at a time: no [n, G, D] tensor is held."""
    n = sent.shape[0]
    rb, off = int(rows_per_block), int(row_offset)
    if not 0 <= off < rb:
        raise ValueError(f"row offset {off} outside [0, {rb})")
    nblk = -(-(off + n) // rb)
    acc = sent.new_empty((nblk, wgt.shape[0], sent.shape[1]))
    for p in range(rb):
        b_lo = 0 if p >= off else 1
        r0 = b_lo * rb + p - off
        if r0 >= n:
            continue
        terms = wgt[:, r0::rb].T[:, :, None] * sent[r0::rb][:, None, :]
        b_hi = b_lo + terms.shape[0]
        if p == off:                  # block 0's first row
            acc[0] = terms[0] if carry is None else carry + terms[0]
            b_lo = 1
            terms = terms[1:]
        if p == 0:                    # the first row of blocks 1, 2, ...
            acc[b_lo:b_hi] = terms
        else:
            acc[b_lo:b_hi] = acc[b_lo:b_hi] + terms
    return acc


def finish_tree(partial: torch.Tensor) -> torch.Tensor:
    """partial [blocks, ...] (blocks > 0) -> their sum as the finish pass
    adds it: min(LEAVES, blocks) leaves of consecutive blocks, each added
    in ascending order from its first, then combined pairwise."""
    nblk = partial.shape[0]
    L = min(LEAVES, nblk)
    leaves = []
    for leaf in range(L):
        lo, hi = leaf * nblk // L, (leaf + 1) * nblk // L
        a = partial[lo]
        for b in range(lo + 1, hi):
            a = a + partial[b]
        leaves.append(a)
    s = 1
    while s < L:
        for i in range(0, L - s, 2 * s):
            leaves[i] = leaves[i] + leaves[i + s]
        s *= 2
    return leaves[0]
