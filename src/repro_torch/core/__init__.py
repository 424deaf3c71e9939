# The paper's primary contribution: the asynchronous FL protocol with
# increasing sample-size sequences, diminishing round step sizes,
# permissible-delay gating, and the DP-ready round computation.
from repro_torch.core.delay import ConstantDelay, SqrtDelay, Theorem5Delay
from repro_torch.core.protocol import (BroadcastMsg, Client, Server,
                                       UpdateMsg)
from repro_torch.core.sequences import (communication_rounds_vs_constant,
                                        lemma1_sequence, rounds_for_budget,
                                        sample_size, sample_sizes,
                                        satisfies_condition3)
from repro_torch.core.simulator import AsyncFLSimulator, run_sync_baseline
from repro_torch.core.stepsizes import (eta_t, per_iteration_stepsizes,
                                        round_stepsizes,
                                        theorem5_round_stepsizes)
from repro_torch.core.strategies import (AggregationStrategy,
                                         FedAsyncStrategy, FedBuffStrategy,
                                         PaperStrategy, get_strategy,
                                         ring_decay)
from repro_torch.core.tasks import (BatchModelTask, LogRegTask, clip_tree,
                                   global_norm, validate_dp_knobs)

__all__ = [
    "ConstantDelay", "SqrtDelay", "Theorem5Delay",
    "BroadcastMsg", "Client", "Server", "UpdateMsg",
    "communication_rounds_vs_constant", "lemma1_sequence",
    "rounds_for_budget", "sample_size", "sample_sizes",
    "satisfies_condition3",
    "AsyncFLSimulator", "run_sync_baseline",
    "eta_t", "per_iteration_stepsizes", "round_stepsizes",
    "theorem5_round_stepsizes",
    "AggregationStrategy", "FedAsyncStrategy", "FedBuffStrategy",
    "PaperStrategy", "get_strategy", "ring_decay",
    "BatchModelTask", "LogRegTask", "clip_tree", "global_norm",
    "validate_dp_knobs",
]
