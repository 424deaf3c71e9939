from repro_torch.core.strategies import PaperStrategy, get_strategy
from repro_torch.core.tasks import LogRegTask, clip_tree, validate_dp_knobs

__all__ = ["LogRegTask", "PaperStrategy", "clip_tree", "get_strategy",
           "validate_dp_knobs"]
