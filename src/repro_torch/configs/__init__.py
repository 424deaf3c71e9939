from repro_torch.configs.base import (DPConfig, FLConfig, ModelConfig,
                                      SampleSequenceConfig, StepSizeConfig,
                                      reduced)
from repro_torch.configs.paper_logreg import fl_config_fig1b

__all__ = ["DPConfig", "FLConfig", "ModelConfig", "SampleSequenceConfig",
           "StepSizeConfig", "fl_config_fig1b", "reduced"]
