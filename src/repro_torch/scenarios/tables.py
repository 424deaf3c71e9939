"""Empirical latency tables: discrete distributions over message
latency in virtual seconds — K bin representatives plus probabilities."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class LatencyTable:
    """Discrete latency distribution: ascending bin values (virtual
    seconds) + probabilities."""
    values: Tuple[float, ...]
    probs: Tuple[float, ...]

    def __post_init__(self):
        v = tuple(float(x) for x in self.values)
        p = tuple(float(x) for x in self.probs)
        if len(v) == 0 or len(v) != len(p):
            raise ValueError("values and probs must be equal-length and "
                             "non-empty")
        if any(x <= 0.0 for x in v):
            raise ValueError("latency bin values must be positive seconds")
        if any(b < a for a, b in zip(v, v[1:])):
            raise ValueError("latency bin values must be ascending")
        if any(x < 0.0 for x in p) or not sum(p) > 0.0:
            raise ValueError("bin probabilities must be non-negative and "
                             "sum to > 0")
        tot = sum(p)
        if abs(tot - 1.0) > 1e-9:
            p = tuple(x / tot for x in p)
        object.__setattr__(self, "values", v)
        object.__setattr__(self, "probs", p)

    @classmethod
    def constant(cls, seconds: float) -> "LatencyTable":
        return cls((float(seconds),), (1.0,))

    @classmethod
    def from_uniform(cls, lo: float, hi: float,
                     n_bins: int = 8) -> "LatencyTable":
        """Uniform(lo, hi) quantized to equal-width bins (centers)."""
        if not 0.0 < lo <= hi:
            raise ValueError(f"need 0 < lo <= hi, got ({lo}, {hi})")
        if hi == lo:
            return cls.constant(lo)
        edges = np.linspace(lo, hi, n_bins + 1)
        mids = 0.5 * (edges[:-1] + edges[1:])
        return cls(tuple(mids), (1.0 / n_bins,) * n_bins)
