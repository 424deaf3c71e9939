from repro_torch.configs.base import (INPUT_SHAPES, DPConfig, FLConfig,
                                      ModelConfig, RunConfig,
                                      SampleSequenceConfig, ShapeConfig,
                                      StepSizeConfig, reduced)
from repro_torch.configs.paper_logreg import (fl_config_fig1a,
                                              fl_config_fig1b)
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config, list_archs

__all__ = ["ASSIGNED_ARCHS", "DPConfig", "FLConfig", "INPUT_SHAPES",
           "ModelConfig", "RunConfig", "SampleSequenceConfig", "ShapeConfig",
           "StepSizeConfig",
           "fl_config_fig1a", "fl_config_fig1b", "get_config", "list_archs",
           "reduced"]
