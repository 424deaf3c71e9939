"""Synthetic datasets for the paper's convex experiments.

The paper uses LIBSVM binary sets and MNIST subsets; those files are not
available offline, so the reference generates statistically similar
synthetic binary-classification problems and federated splits (Fig 2's
biased regime).  The port's copy draws the same numpy streams, so the
data and the splits are bit-identical to the reference's.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def make_binary_dataset(n: int = 10_000, d: int = 64, *, noise: float = 0.5,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly separable + Gaussian label noise (logreg-friendly)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    margin = X @ w / np.sqrt(d)
    y = (margin + noise * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def unbiased_split(X, y, n_clients: int, *, seed: int = 0
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """IID shards: each client sees the global distribution."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(X))
    return [(X[s], y[s]) for s in np.array_split(idx, n_clients)]


def biased_split(X, y, n_clients: int, *, bias: float = 1.0, seed: int = 0
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Label-skewed shards (Fig 2): bias=1 gives fully class-pure clients
    (client c predominantly holds class c % 2), bias=0 reduces to IID."""
    rng = np.random.default_rng(seed)
    pos = np.flatnonzero(y == 1.0)
    neg = np.flatnonzero(y == 0.0)
    rng.shuffle(pos)
    rng.shuffle(neg)
    shards = []
    pos_parts = np.array_split(pos, n_clients)
    neg_parts = np.array_split(neg, n_clients)
    for c in range(n_clients):
        own = pos_parts[c] if c % 2 == 0 else neg_parts[c]
        other = neg_parts[c] if c % 2 == 0 else pos_parts[c]
        n_other = int(round(len(other) * (1.0 - bias)))
        take = np.concatenate([own, other[:n_other]])
        rng.shuffle(take)
        shards.append((X[take], y[take]))
    return shards
