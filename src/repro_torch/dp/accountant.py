"""Differential-privacy accountant — Theorems 3, 4, 6 of the paper
(the reference's ``repro/dp/accountant.py``, in pure Python floats).

The paper generalizes the moments accountant of Abadi et al. (2016) to
*increasing* sample-size sequences q_i = s_{i,c}/N_c = q (i+m)^p and makes
the constants explicit:

  * ``r_from_r0``          — equation (16): r(r0, σ)
  * ``r0_sigma``           — the fixed-point iteration for r0(σ) (D.3.1)
  * ``Theorem4Constants``  — A, B, D, K−, K+, K*, ρ, ρ̂ (γ/α-corrected,
                              i.e. the full Theorem 6 forms)
  * ``sigma_lower_bound``  — case-1 and case-2 σ bounds
  * ``select_parameters``  — the iterative parameter-selection procedure of
                              §3 / D.3.2 (reproduces Examples 1–5)
  * ``moments_epsilon``    — a *numerical* accountant from Lemma 4's explicit
                              moment bound: works for arbitrary {s_i}, used
                              to cross-check the closed forms and by
                              ``build_report`` for the per-client rows.

The arithmetic is the reference's, operation for operation, so every
result is the reference's float.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

E = math.e
SQRT3M1_HALF = (math.sqrt(3.0) - 1.0) / 2.0


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


def r0_sigma(sigma: float, p: float = 1.0, *, tol: float = 1e-12,
             max_iter: int = 200) -> float:
    """Fixed point r0(σ) from D.3.1 (requires σ >= 1.137).

    Solves  r(r0, σ) = (√3−1)/2 · (3p+1)/((p+1)(2p+1)) · (1 − r0/σ)².
    """
    if sigma < 1.137:
        raise ValueError("r0(sigma) iteration requires sigma >= 1.137")
    target_coef = SQRT3M1_HALF * (3 * p + 1) / ((p + 1) * (2 * p + 1))
    r0 = 0.0
    for _ in range(max_iter):
        num = target_coef * (1.0 - r0 / sigma) ** 2
        u0, u1 = u0_u1(r0, sigma) if r0 > 0 else (0.0, 0.0)
        den = 8.0 * (1.0 / (1.0 - u0)
                     + (1.0 / (1.0 - u1)) * E ** 3 / sigma ** 3) \
            * math.exp(3.0 / sigma ** 2)
        new = num / den
        if abs(new - r0) < tol:
            return new
        r0 = new
    return r0


# ---------------------------------------------------------------------------
# Theorem 6 constants (γ, α corrected)
# ---------------------------------------------------------------------------

@dataclass
class Theorem4Constants:
    p: float
    r0: float
    sigma: float
    gamma: float = 0.0       # m/T
    alpha: Optional[float] = None

    def __post_init__(self):
        if self.alpha is None:
            self.alpha = self.r0 / self.sigma
        self.r = r_from_r0(self.r0, self.sigma)
        p, g, a = self.p, self.gamma, self.alpha
        self.rho = ((2 * p + 1) ** 2 / ((p + 1) * (3 * p + 1))
                    * (1 + g) ** (2 + 4 * p) / (1 - a) ** 2)
        self.rho_hat = (2 * p + 1) / (p + 1) ** 2 * (1 + g) ** (2 + 2 * p)
        rr = self.r * self.rho
        # equation (24): threshold τ on c1
        self.tau = (((2 * rr / self.rho_hat + 1.0) ** 2 - 1.0)
                    / (2.0 * rr))

    # -- A, B, D coefficients ------------------------------------------------
    @property
    def A(self) -> float:
        p, g = self.p, self.gamma
        return ((p + 1) ** (1.0 / (1 + 2 * p))
                / (1.0 / (self.r * self.rho)) ** ((1 + p) / (1 + 2 * p))
                * (1 + g) ** (1 + p))

    @property
    def B(self) -> float:
        p, g = self.p, self.gamma
        return ((1 + g) ** (-2.0 * (1 + p) ** 2 / (1 + 2 * p))
                * (p + 1) ** (1.0 / (1 + 2 * p))
                / self.tau ** ((1 + p) / (1 + 2 * p)))

    @property
    def D(self) -> float:
        p, g = self.p, self.gamma
        if p <= 0:
            return math.inf
        return ((self.r0 / self.sigma) ** ((1 + p) / p) / (p + 1)
                * (1 + g) ** (1 + p))

    # -- thresholds ------------------------------------------------------------
    def K_minus(self, epsilon: float, q: float, N_c: int) -> float:
        p = self.p
        return (self.B * epsilon ** ((1 + p) / (1 + 2 * p))
                * q ** (-1.0 / (1 + 2 * p)) * N_c)

    def K_plus(self, epsilon: float, q: float, N_c: int) -> float:
        p = self.p
        return (self.A * epsilon ** ((1 + p) / (1 + 2 * p))
                * q ** (-1.0 / (1 + 2 * p)) * N_c)

    def K_star(self, q: float, N_c: int) -> float:
        if self.p <= 0:
            return math.inf
        return self.D * q ** (-1.0 / self.p) * N_c


def theorem4_simple_B(p: float) -> float:
    """Theorem 4's headline B = (1/(1+p)) ((√3−1)/2 (2p+1))^{(1+p)/(1+2p)}
    (the r0(σ) fixed-point value, γ = 0)."""
    return (1.0 / (1 + p)) * (SQRT3M1_HALF * (2 * p + 1)) \
        ** ((1 + p) / (1 + 2 * p))


# ---------------------------------------------------------------------------
# σ lower bounds
# ---------------------------------------------------------------------------

def privacy_budget_B(epsilon: float, delta: float) -> float:
    return math.sqrt(2.0 * math.log(1.0 / delta) / epsilon)


def delta_from_budget(B: float, epsilon: float) -> float:
    return math.exp(-B * B * epsilon / 2.0)


def sigma_lower_bound_case1(epsilon: float, delta: float, *, p: float,
                            r0: float, sigma: float,
                            gamma: float = 0.0) -> float:
    """Case 1 (K <= K−): σ ≥ √(2 ln(1/δ)/ε) (1+γ)^{2+3p} / √(1 − r0/σ)."""
    return (privacy_budget_B(epsilon, delta)
            * (1 + gamma) ** (2 + 3 * p)
            / math.sqrt(1.0 - r0 / sigma))


def sigma_lower_bound_case2(epsilon: float, delta: float, *, p: float,
                            r0: float, sigma: float, K: float, K_plus: float,
                            gamma: float = 0.0) -> float:
    """Case 2 (K >= K+): the 1.21 · (K/K+)^{(1+2p)/(2+2p)} bound (eq 19)."""
    return ((K / K_plus) ** ((1 + 2 * p) / (2 + 2 * p)) * 1.21
            * privacy_budget_B(epsilon, delta)
            * (1 + gamma) ** (2 + 3 * p)
            / math.sqrt(1.0 - r0 / sigma))


# ---------------------------------------------------------------------------
# Parameter-selection procedure (§3 "Parameter selection", D.3.2)
# ---------------------------------------------------------------------------

@dataclass
class SelectedParameters:
    q: float
    m: float
    T: int
    gamma: float
    sigma: float
    r0: float
    epsilon: float
    delta: float
    budget_B: float
    K: int
    sizes: List[int]
    T_constant: int
    round_reduction: float
    aggregated_noise: float           # sqrt(T) * sigma
    aggregated_noise_constant: float  # sqrt(T_const) * B  (fair comparison)
    binding: str                      # which constraint bound q

    def summary(self) -> str:
        return (f"q={self.q:.3e} m={self.m:.2f} T={self.T} "
                f"gamma={self.gamma:.4f} sigma={self.sigma} "
                f"B={self.budget_B:.3f} delta={self.delta:.3e} "
                f"rounds {self.T_constant}->{self.T} "
                f"(x{self.round_reduction:.2f} fewer), noise "
                f"{self.aggregated_noise_constant:.0f}->"
                f"{self.aggregated_noise:.0f}")


def select_parameters(*, s0c: int, N_c: int, p: float, epsilon: float,
                      sigma: float, K: int, r0: Optional[float] = None,
                      n_gamma_iters: int = 6) -> SelectedParameters:
    """Case-1 selection: choose q ≤ min(q(K−), q(K*)), derive m, T, γ,
    iterate γ to a fixed point, then read off the achievable budget B/δ.

    ``r0=None`` uses the r0(σ) fixed point; Examples 3/5 of the paper use
    r0 = 1/e to relax the K* constraint — pass r0=1/e to reproduce them.
    """
    r0v = r0_sigma(sigma, p) if r0 is None else r0
    gamma = 0.0
    q = m = T = None
    binding = "?"
    for _ in range(n_gamma_iters):
        consts = Theorem4Constants(p=p, r0=r0v, sigma=sigma, gamma=gamma)
        # q small enough that K <= K−  =>  q <= (B ε^{(1+p)/(1+2p)} N_c/K)^{1+2p}
        q_kminus = (consts.B * epsilon ** ((1 + p) / (1 + 2 * p))
                    * N_c / K) ** (1 + 2 * p)
        # q small enough that K <= K*  =>  q <= (D N_c / K)^{p}
        q_kstar = (consts.D * N_c / K) ** p if p > 0 else math.inf
        if q_kminus <= q_kstar:
            q, binding = q_kminus, "K-"
        else:
            q, binding = q_kstar, "K*"
        m = (s0c / (N_c * q)) ** (1.0 / p) if p > 0 else 0.0
        s = N_c * q * (m ** p) if p > 0 else s0c   # = s0c by construction
        T = ((p + 1) * K / (N_c * q)) ** (1.0 / (1 + p))
        new_gamma = m / T
        if abs(new_gamma - gamma) < 1e-9:
            gamma = new_gamma
            break
        gamma = new_gamma

    T_int = int(round(T))
    bound_factor = (1 + gamma) ** (2 + 3 * p) / math.sqrt(1.0 - r0v / sigma)
    budget_B = sigma / bound_factor
    delta = delta_from_budget(budget_B, epsilon)

    sizes = [int(math.ceil(N_c * q * (i + m) ** p)) for i in range(T_int)]
    T_const = int(math.ceil(K / s0c))
    return SelectedParameters(
        q=q, m=m, T=T_int, gamma=gamma, sigma=sigma, r0=r0v,
        epsilon=epsilon, delta=delta, budget_B=budget_B, K=K, sizes=sizes,
        T_constant=T_const,
        round_reduction=T_const / max(T_int, 1),
        aggregated_noise=math.sqrt(T_int) * sigma,
        aggregated_noise_constant=math.sqrt(T_const) * budget_B,
        binding=binding)


# ---------------------------------------------------------------------------
# Numerical moments accountant (Lemma 4, explicit constants)
# ---------------------------------------------------------------------------

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
