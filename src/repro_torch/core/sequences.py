"""Sample-size sequences {s_i} — the paper's central knob (§2.2, Supp. B.3).

Implemented kinds:
  constant : s_i = s0                                   (original FL baseline)
  linear   : s_i = s0 + ceil(a*i)                       (Θ(i), §E.2.2)
  power    : s_i = ceil(N_c * q * (i+m)^p)              (Theorem 4 / DP form)
  ilog     : s_i = ceil((m+i+1) / (16 (d+1)^2 ln((m+i+1)/(2(d+1)))))
             (Theorem 5's Θ(i/ln i) recipe for strongly-convex problems)

Also: condition (3)/(4) checking against a delay function τ, and Lemma 1's
generic recipe S(x) = (x/ω(x) · (g−1)/g)^{1/(g−1)}.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

from repro_torch.configs.base import SampleSequenceConfig


def sample_size(cfg: SampleSequenceConfig, i: int) -> int:
    if cfg.kind == "constant":
        return int(cfg.s0)
    if cfg.kind == "linear":
        return int(cfg.s0 + math.ceil(cfg.a * i))
    if cfg.kind == "power":
        if cfg.N_c and cfg.q:
            return max(1, int(math.ceil(cfg.N_c * cfg.q * (i + cfg.m) ** cfg.p)))
        return max(1, int(math.ceil(cfg.s0 * ((i + cfg.m + 1)
                                              / (cfg.m + 1)) ** cfg.p)))
    if cfg.kind == "ilog":
        d = cfg.d
        z = cfg.m + i + 1
        denom = 16.0 * (d + 1) ** 2 * math.log(max(z / (2.0 * (d + 1)), math.e))
        return max(1, int(math.ceil(z / denom)))
    raise ValueError(f"unknown sample sequence kind {cfg.kind!r}")


def sample_sizes(cfg: SampleSequenceConfig, n_rounds: int) -> List[int]:
    return [sample_size(cfg, i) for i in range(n_rounds)]


def rounds_for_budget(cfg: SampleSequenceConfig, K: int) -> List[int]:
    """Shortest prefix {s_i} with sum >= K (K = total grad computations)."""
    sizes, total, i = [], 0, 0
    while total < K:
        s = sample_size(cfg, i)
        sizes.append(s)
        total += s
        i += 1
        if i > 10_000_000:
            raise RuntimeError("budget K unreachable (sequence too small)")
    return sizes


def cumulative(sizes: Sequence[int]) -> List[int]:
    out, tot = [], 0
    for s in sizes:
        tot += s
        out.append(tot)
    return out


def satisfies_condition3(sizes: Sequence[int], tau: Callable[[float], float],
                         d: int) -> bool:
    """Condition (3): for all i >= d+1, τ(Σ_{j<=i} s_j) >= Σ_{j=i-d..i} s_j."""
    cum = cumulative(sizes)
    for i in range(d + 1, len(sizes)):
        lhs = tau(cum[i])
        rhs = cum[i] - (cum[i - d - 1] if i - d - 1 >= 0 else 0)
        if lhs < rhs:
            return False
    return True


# ---------------------------------------------------------------------------
# Lemma 1: generic recipe from a delay function
# ---------------------------------------------------------------------------

def lemma1_sequence(n_rounds: int, *, g: float = 2.0, m: int = 0, d: int = 1,
                    gamma: Callable[[float], float] = None) -> List[int]:
    """s_i = ceil(S((m+i+1)/(d+1)) / (d+1)) with
    S(x) = (x/ω(x) · (g−1)/g)^{1/(g−1)}, ω(x) = γ((x(g−1)/g)^{g/(g−1)}).

    Default γ(z) = 4 ln(z) (clamped >= 1) matches Theorem 5 (g = 2).
    """
    if gamma is None:
        def gamma(z):
            return max(1.0, 4.0 * math.log(max(z, 1.0)))

    def S(x: float) -> float:
        base = x * (g - 1.0) / g
        omega = gamma(base ** (g / (g - 1.0)))
        return (max(base, 0.0) / omega) ** (1.0 / (g - 1.0))

    return [max(1, int(math.ceil(S((m + i + 1) / (d + 1)) / (d + 1))))
            for i in range(n_rounds)]


def max_constant_sample_size(eta: float, mu: float, d: int) -> int:
    """Supp. C.2.1: with constant step size η, delay bound (13) requires
    τ = (d+1)·s ≤ 1/(η μ), i.e. s ≤ 1/(η μ (d+1))."""
    return max(1, int(1.0 / (eta * mu * (d + 1))))


def communication_rounds_vs_constant(cfg: SampleSequenceConfig,
                                     K: int) -> dict:
    """Reduction metrics vs the constant-size baseline with the same s0.

    Returns T_incr, T_const, reduction factor — the paper's headline
    T ~ sqrt(K) claim is checked against this in benchmarks.
    """
    sizes = rounds_for_budget(cfg, K)
    t_incr = len(sizes)
    t_const = math.ceil(K / max(cfg.s0, 1))
    return {"T_increasing": t_incr, "T_constant": t_const,
            "reduction": t_const / max(t_incr, 1), "sizes": sizes}
