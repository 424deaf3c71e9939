"""Permissible delay functions τ(t) (§2, Supp. C.2.2).

The framework tolerates inconsistent reads up to τ(t) iterations stale;
for strongly-convex problems τ(t) ≈ sqrt(t / ln t) is admissible
(equation (14)).  Theorem 5's concrete instance:

    τ(t) = M1 + sqrt((t + M0) / (4 ln(t + M0)))

with M0 = (m+1)^2 / 4 and M1 = max(d+1, 2Lα/μ, s_0/2-ish term).
``t − τ(t)`` must be increasing — validated by property tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Theorem5Delay:
    """Callable τ(t) from Theorem 5's construction."""
    m: int = 0
    d: int = 1
    M1_extra: float = 0.0  # stands in for 2Lα/μ when curvature is known

    @property
    def M0(self) -> float:
        return (self.m + 1) ** 2 / 4.0

    @property
    def M1(self) -> float:
        z = (self.m + 1) / (16.0 * (self.d + 1) ** 2)
        ln_arg = max((self.m + 1) / (2.0 * (self.d + 1)), math.e)
        third = 0.5 * math.ceil(z / math.log(ln_arg))
        return max(self.d + 1, self.M1_extra, third)

    def __call__(self, t: float) -> float:
        z = t + self.M0
        return self.M1 + math.sqrt(z / (4.0 * math.log(max(z, math.e))))


@dataclass(frozen=True)
class SqrtDelay:
    """τ(t) = c * sqrt(t / ln t) — the admissible asymptotic envelope."""
    c: float = 1.0
    floor: float = 2.0

    def __call__(self, t: float) -> float:
        t = max(t, math.e)
        return max(self.floor, self.c * math.sqrt(t / math.log(t)))


@dataclass(frozen=True)
class ConstantDelay:
    """τ(t) = τ0 — matches the constant-step-size regime (13)."""
    tau0: float = 100.0

    def __call__(self, t: float) -> float:
        return self.tau0


def t_minus_tau_increasing(tau, t_max: int, step: int = 7) -> bool:
    prev = 0 - tau(0)
    for t in range(step, t_max, step):
        cur = t - tau(t)
        if cur < prev - 1e-9:
            return False
        prev = cur
    return True
