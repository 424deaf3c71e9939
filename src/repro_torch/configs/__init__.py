from repro_torch.configs.base import (DPConfig, FLConfig,
                                      SampleSequenceConfig, StepSizeConfig)
from repro_torch.configs.paper_logreg import fl_config_fig1b

__all__ = ["DPConfig", "FLConfig", "SampleSequenceConfig", "StepSizeConfig",
           "fl_config_fig1b"]
