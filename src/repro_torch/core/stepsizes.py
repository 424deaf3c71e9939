"""Step-size schedules η_t and round step sizes η̄_i (Supp. B.4, Lemma 2).

Paper schemes:
  constant  : η_t = η0
  inv_t     : η_t = η0 / (1 + β t)          (strongly convex experiments)
  inv_sqrt  : η_t = η0 / (1 + β sqrt(t))    (plain convex / non-convex)
  theorem5  : η̄_i = (12/μ) / (Σ_{j<i} s_j + 2 M1 + sqrt(((m+1)²/4 + Σ)/ln(·)))

``round_transform`` (the paper's "diminishing₂") freezes η within a round:
η̄_i = η_{t(i)} with t(i) = Σ_{j<i} s_j — Lemma 2 proves the resulting
{η̄_i} still satisfies the convergence preconditions.
"""
from __future__ import annotations

import math
from typing import List, Sequence

from repro_torch.configs.base import StepSizeConfig
from repro_torch.core.delay import Theorem5Delay


def eta_t(cfg: StepSizeConfig, t: float) -> float:
    if cfg.kind == "constant":
        return cfg.eta0
    if cfg.kind == "inv_t":
        return cfg.eta0 / (1.0 + cfg.beta * t)
    if cfg.kind == "inv_sqrt":
        return cfg.eta0 / (1.0 + cfg.beta * math.sqrt(t))
    raise ValueError(f"unknown step size kind {cfg.kind!r}")


def round_stepsizes(cfg: StepSizeConfig, sizes: Sequence[int]) -> List[float]:
    """η̄_i for each round i given the sample-size sequence."""
    out, cum = [], 0
    for s in sizes:
        out.append(eta_t(cfg, cum))
        cum += s
    return out


def theorem5_round_stepsizes(mu: float, sizes: Sequence[int], *,
                             m: int = 0, d: int = 1,
                             M1_extra: float = 0.0) -> List[float]:
    """η̄_i = (12/μ) / (Σ_{j<i} s_j + 2M1 + sqrt((M0+Σ)/ln(M0+Σ)))  (Thm 5)."""
    delay = Theorem5Delay(m=m, d=d, M1_extra=M1_extra)
    M0, M1 = delay.M0, delay.M1
    out, cum = [], 0
    for s in sizes:
        z = max(M0 + cum, math.e)
        denom = cum + 2.0 * M1 + math.sqrt(z / math.log(z))
        out.append(12.0 / (mu * denom))
        cum += s
    return out


def per_iteration_stepsizes(cfg: StepSizeConfig,
                            sizes: Sequence[int]) -> List[List[float]]:
    """The paper's "diminishing₁": fine-grained η_t within each round."""
    out, cum = [], 0
    for s in sizes:
        out.append([eta_t(cfg, cum + h) for h in range(s)])
        cum += s
    return out
