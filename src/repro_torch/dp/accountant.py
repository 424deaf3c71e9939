"""Per-client moments accounting for the telemetry report.

The port's copy of the numerical accountant of ``repro.dp.accountant``
(Lemma 4's explicit moment bound, Abadi et al.'s moments accountant
generalized to increasing sample sizes) — the part ``build_report``
calls when ``dp_sigma > 0``.  Pure math.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

E = math.e


def u0_u1(r0: float, sigma: float):
    if not 0.0 < r0 < sigma:
        # With r0 >= sigma the denominator sigma - r0 flips sign, u0/u1 go
        # negative, the < 1 guard in r_from_r0 passes vacuously, and a
        # finite but meaningless r leaks into Theorem4Constants /
        # select_parameters.  Equation (16) is only defined on 0 < r0 < σ.
        raise ValueError(
            f"equation (16) requires 0 < r0 < sigma; got r0={r0}, "
            f"sigma={sigma}")
    root = math.sqrt(r0 * sigma)
    u0 = 2.0 * root / (sigma - r0)
    u1 = 2.0 * E * root / ((sigma - r0) * sigma)
    return u0, u1


def r_from_r0(r0: float, sigma: float) -> float:
    u0, u1 = u0_u1(r0, sigma)
    if u0 >= 1.0 or u1 >= 1.0:
        raise ValueError(f"u0={u0:.4f}, u1={u1:.4f} must be < 1 "
                         f"(sigma too small for r0={r0})")
    return r0 * 8.0 * (1.0 / (1.0 - u0)
                       + (1.0 / (1.0 - u1)) * E ** 3 / sigma ** 3) \
        * math.exp(3.0 / sigma ** 2)


def moments_delta(sizes: Sequence[int], N_c: int, sigma: float,
                  epsilon: float, *, r0: Optional[float] = None,
                  lambda_max: int = 256) -> float:
    """δ = min_λ exp(Σ_i α_i(λ) − λ ε) using Lemma 4's bound

        α_i(λ) ≤ s²λ(λ+1)/(N(N−s)σ²) + (r/r0)·s³λ²(λ+1)/(N(N−s)²σ³).

    λ is capped by the lemma's validity condition λ ≤ σ² ln(N/(s σ)).
    """
    if r0 is None:
        r0 = max(s / N_c for s in sizes) * sigma
        r0 = min(max(r0, 1e-6), 1.0 / E)
    r = r_from_r0(r0, sigma)
    best = math.inf
    for lam in range(1, lambda_max + 1):
        ok = True
        total = 0.0
        for s in sizes:
            s = min(s, N_c - 1)
            if lam > sigma ** 2 * math.log(max(N_c / (s * sigma), E)):
                ok = False
                break
            t1 = s * s * lam * (lam + 1) / (N_c * (N_c - s) * sigma ** 2)
            t2 = (r / r0) * s ** 3 * lam ** 2 * (lam + 1) \
                / (N_c * (N_c - s) ** 2 * sigma ** 3)
            total += t1 + t2
        if not ok:
            break
        best = min(best, total - lam * epsilon)
    return math.exp(best) if best < math.inf else 1.0


def moments_epsilon(sizes: Sequence[int], N_c: int, sigma: float,
                    delta: float, *, r0: Optional[float] = None,
                    tol: float = 1e-4) -> float:
    """Smallest ε with moments_delta(...) <= δ (bisection)."""
    lo, hi = 1e-4, 200.0
    if moments_delta(sizes, N_c, sigma, hi, r0=r0) > delta:
        return math.inf
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if moments_delta(sizes, N_c, sigma, mid, r0=r0) <= delta:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol:
            break
    return hi


def per_client_accounting(sizes_rows: Sequence[Sequence[int]], N_c: int,
                          sigma: float, delta: float, *,
                          r0: Optional[float] = None
                          ) -> List[dict]:
    """Per-client (ε, σ, rounds-contributed) rows for a MetricsReport.

    ``sizes_rows[c]`` is the sequence of sample sizes client c *actually
    sent* (its participation record, not the planned schedule) — in the
    paper's local-DP regime each client's privacy spend depends only on
    its own mechanism invocations, so the moments accountant runs per
    client over that row.  Identical rows share one bisection via a
    cache, so fleets with a common schedule cost a single accountant
    pass.  An infinite ε (σ too small for δ at this N_c) is reported as
    ``None`` so the rows stay JSON-serializable.
    """
    cache: dict = {}
    rows: List[dict] = []
    for c, sizes in enumerate(sizes_rows):
        key = tuple(int(s) for s in sizes)
        if key not in cache:
            if not key or sigma <= 0:
                eps = 0.0 if not key else math.inf
            else:
                try:
                    eps = moments_epsilon(list(key), N_c, sigma, delta,
                                          r0=r0)
                except ValueError:
                    # sigma below Lemma 4's validity regime (u0/u1 >= 1):
                    # no finite moments bound — report as unbounded
                    eps = math.inf
            cache[key] = eps
        eps = cache[key]
        rows.append({
            "client": c,
            "rounds_contributed": len(key),
            "samples": int(sum(key)),
            "sigma": float(sigma),
            "delta": float(delta),
            "epsilon": None if math.isinf(eps) else float(eps),
        })
    return rows
