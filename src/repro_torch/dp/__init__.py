from repro_torch.dp.accountant import moments_epsilon, per_client_accounting
from repro_torch.dp.mechanism import (add_gaussian_noise, clip_accumulate,
                                      clip_tree, dp_sgd_round, tree_norm)

__all__ = ["add_gaussian_noise", "clip_accumulate", "clip_tree",
           "dp_sgd_round", "moments_epsilon", "per_client_accounting",
           "tree_norm"]
