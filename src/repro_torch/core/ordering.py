"""Theorem 1's iteration-ordering map ρ (Supp. B.1; the reference's
``repro/core/ordering.py``, numpy).

SETUP (Algorithm 2) assigns each of round i's s_i global iterations to a
client via coin flips: a(i, t) = c with probability p_c.  The map

    ρ(c, i, h) = Σ_{l<i} s_l + min{t' : h = |{t <= t' : a(i,t) = c}|}

labels every client-local iteration (c, i, h) with a global iteration
count t; the paper proves ρ is a bijection, which is what lets the
distributed execution be analyzed as ONE asynchronous SGD sequence
{w_t}.  We implement ρ and its inverse and property-test bijectivity.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def make_assignment(sizes: Sequence[int], p: Sequence[float], *,
                    seed: int = 0) -> List[np.ndarray]:
    """a(i, t): per-round arrays of client ids (Algorithm 2 lines 5-8)."""
    rng = np.random.default_rng(seed)
    pv = np.asarray(p, float)
    pv = pv / pv.sum()
    return [rng.choice(len(p), size=s, p=pv) for s in sizes]


def client_sizes(assignment: List[np.ndarray], n_clients: int
                 ) -> List[List[int]]:
    """s_{i,c} = |{t : a(i,t) = c}|."""
    return [[int(np.sum(a == c)) for a in assignment]
            for c in range(n_clients)]


def rho(assignment: List[np.ndarray], c: int, i: int, h: int) -> int:
    """Global iteration index of client c's h-th iteration in round i
    (0-based h; the paper's h counts completed iterations)."""
    base = sum(len(a) for a in assignment[:i])
    a = assignment[i]
    positions = np.flatnonzero(a == c)
    return base + int(positions[h])


def rho_inverse(assignment: List[np.ndarray], t: int
                ) -> Tuple[int, int, int]:
    """(c, i, h) with ρ(c, i, h) = t."""
    i = 0
    while t >= len(assignment[i]):
        t -= len(assignment[i])
        i += 1
    c = int(assignment[i][t])
    h = int(np.sum(assignment[i][:t] == c))
    return c, i, h


def is_bijection(assignment: List[np.ndarray], n_clients: int) -> bool:
    total = sum(len(a) for a in assignment)
    seen = set()
    for c in range(n_clients):
        for i, a in enumerate(assignment):
            for h in range(int(np.sum(a == c))):
                seen.add(rho(assignment, c, i, h))
    return seen == set(range(total))
