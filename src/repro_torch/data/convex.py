"""Synthetic datasets for the paper's convex experiments.

The paper uses LIBSVM binary sets and MNIST subsets; those files are not
available offline, so the reference generates statistically similar
synthetic binary-classification problems.  The port's copy draws the
same numpy stream, so ``X, y`` are bit-identical to the reference's.
"""
from __future__ import annotations

from typing import Tuple

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
