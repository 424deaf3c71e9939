from repro_torch.core.strategies import (FedAsyncStrategy, FedBuffStrategy,
                                         PaperStrategy, get_strategy,
                                         ring_decay)
from repro_torch.core.tasks import LogRegTask, clip_tree, validate_dp_knobs

__all__ = ["FedAsyncStrategy", "FedBuffStrategy", "LogRegTask",
           "PaperStrategy", "clip_tree", "get_strategy", "ring_decay",
           "validate_dp_knobs"]
