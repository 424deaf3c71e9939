"""The least time each engine kernel could take on one H100, from the
bytes it must move and the operations it must do for its arguments.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; where the work depends on the data (rows
delivered, rows done) the count is of what these arguments need.  The
bound is the larger of the bytes at the memory rate and the operations at
their type's peak (f32 and int32 run on separate units).  Published
peaks of the H100 SXM at its 700 W limit (NVIDIA's data sheet, dense).
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # f32 outside the tensor cores (TF32 off)
INT32_OPS = 33.5e12
# int32 operations of one element of the in-kernel noise whose normal is
# needed: threefry2x32 (2 key adds, 20 rounds of add, rotate (shift,
# shift, or) and xor, 5 key injections of 3 adds) and the two shifts
# that take the top 24 bits
PRNG_INT_OPS = 2 + 20 * 5 + 5 * 3 + 2
# f32 operations of that element: Box-Muller (u1: mul + add; u2: mul;
# -2 log u1: log + mul; sqrt; 2 pi u2: mul; cos; the product) and the
# clip, noise and weighting math (4 mul + 2 add)
PRNG_F32_OPS = 10 + 6
F4 = 4


def bound_terms(nbytes: float, flops: float,
                int_ops: float = 0.0) -> Tuple[float, float]:
    """(bytes seconds, operations seconds)."""
    return (nbytes / HBM_BYTES_PER_S,
            max(flops / F32_FLOPS, int_ops / INT32_OPS))


def bound(nbytes: float, flops: float, int_ops: float = 0.0) -> float:
    """Seconds: the larger of the two terms."""
    return max(bound_terms(nbytes, flops, int_ops))


def server_bound(D: int, A: int, *, arr: bool, fired: int = 0,
                 hit: bool = False, buffered: bool = False,
                 flush: bool = False) -> float:
    """``server_apply``: read v and, where the step needs them, the due
    slot's A rows, the due overflow row and the buffer; write v', the
    reset rows, the buffer where it changes and the fired broadcast rows;
    a product and a sum per due element, a difference per element of v'."""
    rows_in = 1 + (A if arr else 0) + (A if arr and hit else 0)
    rows_out = 1 + fired + A + (A if hit else 0)
    if buffered and (arr or flush):
        rows_in += 1
        rows_out += 1
    applied = flush if buffered else arr
    flops = (2 * A * D if arr else 0) + (D if applied else 0)
    return bound(F4 * D * (rows_in + rows_out), flops)


def deliver_bound(C: int, D: int, nt: int) -> float:
    """``tick_deliver``: a taken row reads its U row and its broadcast
    row once, another row its w row; every row is written; the row's
    broadcast index (int64), flag (byte) and step size are read; a
    product and a difference per element of a taken row."""
    return bound(F4 * (nt * D + (C - nt) * D + D + C * D + C) + 9 * C,
                 2 * nt * D)


def rows_bound(C: int, D: int, G: int, nd: int, nblk: int) -> float:
    """``tick_scatter_rows``: read sent, w, U on the nd done rows, the
    G x C weights, eta and done; write w', U' and the nblk block
    partials; G products and sums per element of sent, three operations
    per element of a done row."""
    return bound(F4 * (2 * C * D + nd * D + G * C + C + 2 * C * D
                       + nblk * G * D) + C, 2 * G * C * D + 3 * nd * D)


def finish_bound(nblk: int, G: int, D: int) -> float:
    """``tick_scatter_finish``: read the partials, the G rows and any_g;
    write the G rows; one add per partial element and one per row."""
    return bound(F4 * (nblk * G * D + 2 * G * D) + G,
                 nblk * G * D + G * D)


def noise_bound(C: int, D: int, nd: int, *, clip: bool) -> float:
    """``cohort_clip_noise`` without the weighted sum: read u, the noise
    of the nd masked rows, mask and weights; write out; a product and a
    sum per masked element for the noise, and with a row clip a product
    and a sum for the norm and a product for the scale."""
    return bound(F4 * (2 * C * D + nd * D + 2 * C),
                 (2 + (3 if clip else 0)) * nd * D)


def noise_prng_bound(C: int, D: int, nd: int) -> float:
    """``cohort_clip_noise_prng`` without the weighted sum: read u, mask
    and weights; write out; a hash and its normal for each element of a
    masked row only."""
    hashed = nd * D
    return bound(F4 * (2 * C * D + 2 * C), PRNG_F32_OPS * hashed,
                 PRNG_INT_OPS * hashed)
