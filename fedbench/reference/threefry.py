"""Plain threefry2x32 draws, the stream the simulated protocol is keyed by.

A frozen plain copy of the counter-based generator the cohort engines
address their draws with (jax's threefry2x32 under its partitionable
layout), written on int64 tensors that hold uint32 words.  The reference
works every draw out again from the seed with these functions: the
clients' sample indices and the rounds' Gaussian noise.

* a key is two uint32 words; ``key(seed) == (0, seed mod 2**32)``;
* ``fold_in(key, x) == threefry2x32(key, (0, x))``;
* the bits of flat element ``n`` of a draw are ``x0 ^ x1`` of
  ``threefry2x32(key, (n >> 32, n mod 2**32))``;
* a normal is ``sqrt(2) * erfinv(u)``, ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` from the top 23 bits, with the f32 inverse
  error function polynomial of Giles (XLA's ``ErfInv``).
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words (x0, x1) under
    key words (k0, k1); ints or int64 tensors that broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for n in range(5):
        for r in _ROTATIONS[n % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(n + 1) % 3]) & M32
        x1 = (x1 + ks[(n + 2) % 3] + n + 1) & M32
    return x0, x1


def key(seed: int):
    """The key of an integer seed, as two Python ints."""
    return 0, int(seed) & M32


def fold_in(k, data):
    """Fold integer ``data`` (an int, or an int64 tensor) into key ``k``
    (a pair of ints, or of int64 tensors) -> a pair of the same kind."""
    if torch.is_tensor(data):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    return threefry2x32(k[0], k[1], 0, data)


def bits(k, start: int, n: int, device) -> torch.Tensor:
    """The 32 random bits of flat elements ``start .. start + n - 1`` of
    a draw under one key (a pair of ints)."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(int(k[0]), int(k[1]), idx >> 32, idx & M32)
    return x0 ^ x1


# Giles' single-precision inverse error function (XLA's ErfInv)
_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)
_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
        2.83297682)
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(x * -x)
    small = w < 5.0
    # the root in f64 rounded once: the correctly rounded f32 root
    w = torch.where(small, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(small, _LT5[0], _GE5[0]).float()
    for a, b in zip(_LT5[1:], _GE5[1:]):
        p = torch.where(small, a, b).float() + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(k, start: int, n: int, device) -> torch.Tensor:
    """Standard normals (f32) of flat elements ``start .. start + n - 1``
    of a draw under key ``k``."""
    b = bits(k, start, n, device)
    u01 = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_LO, dtype=torch.float32, device=device)
    # the span 1 - nextafter(-1, 0) rounds to 2.0 in f32: u01 * 2 is exact
    u = torch.maximum(lo, u01 * 2.0 + lo)
    return _SQRT2 * _erfinv(u)


_TWO_M24 = 2.0 ** -24
_TWO_M25 = 2.0 ** -25
_TWO_PI = float(np.float32(2.0 * np.pi))


def box_muller(k, start: int, n: int, device) -> torch.Tensor:
    """The counter-based normals of flat elements ``start .. start + n -
    1`` under key ``k`` (ints): the two hash words of each element's
    counter, the top 24 bits of each as ``u1 = b1 2^-24 + 2^-25`` and
    ``u2 = b2 2^-24``, ``sqrt(-2 log u1) cos(2 pi u2)`` in f32."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(int(k[0]), int(k[1]), idx >> 32, idx & M32)
    u1 = (b1 >> 8).float() * _TWO_M24 + _TWO_M25
    u2 = (b2 >> 8).float() * _TWO_M24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
