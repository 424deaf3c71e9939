"""A mirror of jax's threefry2x32 PRNG on torch tensors.

Every contract of the reference rests on message-addressed threefry draws
(``fold_in`` chains keyed by the salts in ``repro_torch.analysis.salts``),
so the port reproduces jax's bits exactly, under jax's default
``jax_threefry_partitionable=True``:

* a key is an int64 tensor ``[..., 2]`` holding two uint32 words;
  ``PRNGKey(seed) == [0, seed & 0xFFFFFFFF]`` for any seed in the int64
  range, as jax gives it under its default ``jax_enable_x64=False``;
* ``fold_in(key, d) == threefry2x32(key, (0, d))``, ``d`` a uint32;
* ``random_bits(key, shape)`` is ``x0 ^ x1`` of
  ``threefry2x32(key, (hi, lo))`` over the 64-bit flat index;
* ``uniform`` fills the mantissa of a float in [1, 2) and shifts;
* ``normal`` is ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` with
  XLA's f32 ``ErfInv`` polynomial (Giles), copied below.

uint32 words live in int64 tensors masked to 32 bits, so every op runs
on any device and dtype promotion never wraps.  The hash also accepts
Python ints, so a scalar key chain (one key per tick) costs no device
launches: keep scalar keys on the CPU and hand them to the draws.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _rounds(x0: Word, x1: Word, rots) -> Tuple[Word, Word]:
    for r in rots:
        x0 = (x0 + x1) & MASK32
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds), jax's unrolled lowering.

    Arguments are uint32 values as Python ints or int64 tensors that
    broadcast together; returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for n in range(5):
        x0, x1 = _rounds(x0, x1, _ROT0 if n % 2 == 0 else _ROT1)
        x0 = (x0 + ks[(n + 1) % 3]) & MASK32
        x1 = (x1 + ks[(n + 2) % 3] + (n + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` -> ``[0, seed & 0xFFFFFFFF]``.

    This is jax under ``jax_enable_x64=False``, its default and the
    setting this mirror assumes (the port does not read jax's config):
    the seed becomes an int64, then a 32-bit int, so the high word is 0
    and a negative seed wraps.  Outside the int64 range jax raises
    ``OverflowError``, and so does this."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} is outside the int64 range")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``key [..., 2]`` and integer
    ``data`` (int or tensor) broadcast together -> keys ``[..., 2]``.

    A Python int outside ``[0, 2**32)`` raises ``OverflowError``, as jax
    does; other data (tensors, numpy integers) is taken mod 2**32."""
    if not torch.is_tensor(data):
        if isinstance(data, int) and not 0 <= data <= MASK32:
            raise OverflowError(f"fold_in data {data} is outside uint32")
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> keys ``[num, 2]`` on the key's
    device: under the partitionable layout key ``i`` is both words of
    ``threefry2x32(key, (hi, lo))`` on the flat index ``i``."""
    x0, x1 = counter_words(key, num, device=key.device)
    return torch.stack([x0, x1], dim=-1)


def _scalar_key(key: torch.Tensor) -> Tuple[int, int]:
    if tuple(key.shape) != (2,):
        raise ValueError(f"need one key of shape (2,), got {tuple(key.shape)}")
    k0, k1 = key.tolist()
    return int(k0), int(k1)


def counter_words(key: torch.Tensor, n: int, device=None, *,
                  start: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both output words ``(x0, x1)`` of ``threefry2x32(key, (hi, lo))``
    over the flat indices ``start .. start + n - 1`` (the counters
    ``random_bits`` hashes).  ``key`` is one key, kept on the CPU."""
    k0, k1 = _scalar_key(key)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return threefry2x32(k0, k1, idx >> 32, idx & MASK32)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """32 random bits per element (int64 tensor holding uint32 values),
    ``jax.random.bits(key, shape)`` under the partitionable layout.

    ``key`` is one key; keep it on the CPU — its two words become kernel
    scalars, so the draw itself makes no host round trip."""
    n = int(np.prod(shape)) if len(shape) else 1
    b0, b1 = counter_words(key, n, device=device)
    return (b0 ^ b1).reshape(tuple(shape))


def keys_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.bits(k, shape))(keys)`` for a
    batch of keys ``[N, 2]`` -> ``[N, *shape]`` on the keys' device."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], idx >> 32,
                          idx & MASK32)
    return (b0 ^ b1).reshape((keys.shape[0],) + tuple(shape))


def keys_uniform(keys: torch.Tensor, shape: Sequence[int] = ()
                 ) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.uniform(k, shape))(keys)`` (f32 in
    [0, 1)) for a batch of keys ``[N, 2]`` -> ``[N, *shape]``."""
    return _bits_to_unit(keys_bits(keys, shape))


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): mantissa of a float in [1, 2), - 1."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """f32 prefix sums over the last axis in XLA's CPU order (the
    reduce-window rewrite behind ``jnp.cumsum``): sequential sums inside
    chunks of 16 from 0.0, plus the sequential exclusive prefix of the
    chunk totals.  Draws that feed a ``jnp.cumsum`` in the reference
    (renewal switch times, table-weight CDFs) go through this, not
    ``torch.cumsum``, whose order differs."""
    n = x.shape[-1]
    if n > 256:
        raise ValueError(f"cumsum_xla covers up to 256 terms, got {n}")
    m = -(-n // 16)
    xp = torch.nn.functional.pad(x, (0, 16 * m - n))
    ch = xp.reshape(x.shape[:-1] + (m, 16))
    acc = torch.zeros_like(ch[..., 0])
    inner = []
    for j in range(16):
        acc = acc + ch[..., j]
        inner.append(acc)
    inner = torch.stack(inner, dim=-1)                  # [..., m, 16]
    off = [torch.zeros_like(inner[..., 0, 15])]
    tot = off[0]
    for c in range(1, m):
        tot = tot + inner[..., c - 1, 15]
        off.append(tot)
    out = inner + torch.stack(off, dim=-1)[..., None]
    return out.reshape(x.shape[:-1] + (16 * m,))[..., :n]


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.

    XLA computes ``f * (hi - lo) + lo`` as one fused multiply-add: one
    rounding.  Where ``hi - lo`` (in f32, as jax takes it) is a power of
    two, ``[0, 1)`` and ``normal``'s range among them, the f32 product is
    exact and the f32 sum rounds once.  Otherwise the product (exact in
    f64) and the sum are taken in f64 and rounded to f32; that differs
    from one rounding only if the f64 sum lands exactly halfway between
    two f32 values, which the tests' draws never do."""
    return _unit_to_range(_bits_to_unit(random_bits(key, shape,
                                                    device=device)),
                          minval, maxval)


def _unit_to_range(f: torch.Tensor, minval: float,
                   maxval: float) -> torch.Tensor:
    """``uniform``'s map of f32 draws in [0, 1) onto [minval, maxval)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    span = float(np.float32(maxval) - np.float32(minval))
    if span == 0.0 or math.frexp(span)[0] in (0.5, -0.5):
        return torch.maximum(lo, f * (hi - lo) + lo)
    x = f.double() * float(span) + float(np.float32(minval))
    return torch.maximum(lo, x.to(torch.float32))


# XLA's f32 ErfInv (chlo_legalize_to_hlo: Giles' single-precision
# approximation), as jax's pallas lowering helper copies it.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function with XLA's polynomial.

    The square root is taken in f64 and rounded once, which is the
    correctly rounded f32 root XLA takes: torch's f32 ``sqrt`` on a large
    CPU tensor is not always correctly rounded, and which elements it
    misses varies from one process to the next."""
    w = -torch.log1p(x * -x)
    lt5 = w < 5.0
    w = torch.where(lt5, w - 2.5,
                    torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)
    p = torch.where(lt5, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt5, a, b).to(torch.float32) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


#: elements a ``normal`` draw hashes at once: its ~200 int64 temporaries
#: of a slab take a few GB at most (a 256000 x 2304 embedding drawn whole
#: would hold several 4.7 GB ones)
NORMAL_SLAB = 1 << 24


def normal(key: torch.Tensor, shape: Sequence[int],
           device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``.

    Drawn over the flat index in slabs of ``NORMAL_SLAB`` elements, each
    slab hashing its own counters, so the bits are those of one draw."""
    n = int(np.prod(shape)) if len(shape) else 1
    slab = NORMAL_SLAB
    if n <= slab:
        u = uniform(key, shape, _NORMAL_LO, 1.0, device=device)
        return _SQRT2_F32 * erf_inv(u)
    return _normal_flat(key, 0, n, device).reshape(tuple(shape))


def _normal_flat(key: torch.Tensor, start: int, n: int,
                 device) -> torch.Tensor:
    """The normals of flat indices ``start .. start + n - 1``, hashed in
    slabs of ``NORMAL_SLAB``: each element is a function of its own
    index, so any cut of the range gives the same bits."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, NORMAL_SLAB):
        b0, b1 = counter_words(key, min(NORMAL_SLAB, n - lo), device=device,
                               start=start + lo)
        u = _unit_to_range(_bits_to_unit(b0 ^ b1), _NORMAL_LO, 1.0)
        out[lo:lo + NORMAL_SLAB] = _SQRT2_F32 * erf_inv(u)
    return out


def normal_rows(key: torch.Tensor, shape: Sequence[int], row_lo: int,
                row_hi: int, device=None) -> torch.Tensor:
    """Rows ``row_lo:row_hi`` of ``normal(key, shape)`` (leading axis),
    bit for bit, without drawing the others: the slice a rank holds of
    a draw over the whole client axis."""
    shape = tuple(shape)
    if not 0 <= row_lo <= row_hi <= shape[0]:
        raise ValueError(f"rows [{row_lo}, {row_hi}) outside {shape[0]}")
    per = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    return _normal_flat(key, row_lo * per, (row_hi - row_lo) * per,
                        device).reshape((row_hi - row_lo,) + shape[1:])


_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), vmapped
    over a batch of keys ``[..., 2]`` -> ``[..., *shape]`` (int64 tensor)
    on the keys' device.

    jax's 32-bit path: the key splits in two, each half gives 32 random
    bits per element (``hi``, ``lo``), and with ``span = maxval - minval``
    (1 when ``maxval <= minval``) and ``mult = (2**16 % span)**2 % span``
    (the square wraps at 32 bits too, so ``mult`` is 0 for spans past
    2**16) the draw is ``minval + ((hi % span) * mult + lo % span) % span``,
    every product and sum wrapping at 32 bits as uint32 arithmetic does.
    The bounds are clipped to int32, as jax converts them."""
    lo_v = min(max(int(minval), _INT32_MIN), _INT32_MAX)
    hi_v = min(max(int(maxval), _INT32_MIN), _INT32_MAX)
    span = 1 if hi_v <= lo_v else (hi_v - lo_v) & MASK32
    mult = ((2 ** 16 % span) ** 2 & MASK32) % span   # 0 past span 2**16
    batch = key.shape[:-1]
    halves = split_batch(key.reshape(-1, 2))                  # [N, 2, 2]
    higher = keys_bits(halves[:, 0], shape)
    lower = keys_bits(halves[:, 1], shape)
    off = ((higher % span) * mult) & MASK32
    off = ((off + lower % span) & MASK32) % span
    out = (lo_v + off) & MASK32                 # int32 add, wrapping
    out = torch.where(out > _INT32_MAX, out - 2 ** 32, out)
    return out.reshape(tuple(batch) + tuple(shape))


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int64) shuffled
    by jax's sort-based method — ``ceil(3 log(max(1, n)) / log(2**32 -
    1))`` rounds, each splitting the key (``key, sub = split(key)``) and
    stably sorting the values by ``random_bits(sub, (n,))``, compared as
    unsigned 32-bit keys.  ``key`` is one key on the CPU."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device=device),
                           stable=True).indices
        x = x[order]
    return x


def split_batch(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.vmap(lambda k: jax.random.split(k, num))(keys)``: keys
    ``[N, 2]`` -> ``[N, num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], idx >> 32,
                          idx & MASK32)
    return torch.stack([x0, x1], dim=-1)
