"""DP planning for FL runs: derive (sizes, round sigmas, T) from a budget
(the reference's ``repro/dp/planning.py`` over the port's configs).

Bridges the Theorem-4 accountant to FLConfig — given a grad budget K,
privacy target (epsilon, delta), and the client data-set size, returns a
ready-to-run FLConfig with the increasing sample-size sequence and the
per-round sigma, plus the constant-sequence comparison the paper makes.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.configs.base import (DPConfig, FLConfig,
                                      SampleSequenceConfig, StepSizeConfig)
from repro_torch.dp.accountant import SelectedParameters, select_parameters


def plan_dp_fl(*, n_clients: int, N_c: int, K: int, epsilon: float,
               sigma: float, s0c: int = 16, p: float = 1.0,
               clip_norm: float = 0.1, r0: Optional[float] = 1 / math.e,
               eta0: float = 0.15, beta: float = 0.001,
               granularity: str = "example") -> tuple:
    """Returns (FLConfig, SelectedParameters)."""
    sel = select_parameters(s0c=s0c, N_c=N_c, p=p, epsilon=epsilon,
                            sigma=sigma, K=K, r0=r0)
    fl = FLConfig(
        n_clients=n_clients,
        sample_seq=SampleSequenceConfig(kind="power", s0=s0c, p=p,
                                        q=sel.q, m=sel.m, N_c=N_c),
        step_size=StepSizeConfig(kind="inv_t", eta0=eta0, beta=beta,
                                 round_transform=True),
        dp=DPConfig(enabled=True, clip_norm=clip_norm, sigma=sel.sigma,
                    granularity=granularity, delta=sel.delta,
                    epsilon=epsilon),
        total_grads=K,
    )
    return fl, sel


def compare_constant(sel: SelectedParameters) -> dict:
    """The paper's constant-sequence comparison at equal privacy."""
    return {
        "rounds": {"increasing": sel.T, "constant": sel.T_constant,
                   "reduction": sel.round_reduction},
        "aggregated_noise": {
            "increasing": sel.aggregated_noise,
            "constant": sel.aggregated_noise_constant,
            "reduction": sel.aggregated_noise_constant
            / max(sel.aggregated_noise, 1e-9)},
        "budget_B": sel.budget_B,
        "delta": sel.delta,
    }
