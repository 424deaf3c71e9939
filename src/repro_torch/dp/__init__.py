from repro_torch.dp.accountant import (SelectedParameters, Theorem4Constants,
                                       delta_from_budget, moments_delta,
                                       moments_epsilon, per_client_accounting,
                                       privacy_budget_B, r0_sigma, r_from_r0,
                                       select_parameters,
                                       sigma_lower_bound_case1,
                                       sigma_lower_bound_case2,
                                       theorem4_simple_B)
from repro_torch.dp.mechanism import (add_gaussian_noise, clip_accumulate,
                                      clip_tree, dp_sgd_round, tree_norm)
from repro_torch.dp.planning import compare_constant, plan_dp_fl

__all__ = [
    "SelectedParameters", "Theorem4Constants", "delta_from_budget",
    "moments_delta", "moments_epsilon", "per_client_accounting",
    "privacy_budget_B", "r0_sigma", "r_from_r0", "select_parameters",
    "sigma_lower_bound_case1", "sigma_lower_bound_case2",
    "theorem4_simple_B", "add_gaussian_noise", "clip_accumulate",
    "clip_tree", "dp_sgd_round", "tree_norm", "compare_constant",
    "plan_dp_fl",
]
