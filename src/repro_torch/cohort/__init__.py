"""The device-resident cohort engine: the whole client population as
``[C, D]`` blocks on the card, the paper's protocol tick by tick."""
from repro_torch.cohort.device import DeviceCohortEngine, resolve_device
from repro_torch.cohort.simulator import (DeviceCohortSimulator,
                                          as_cohort_task, make_simulator)
from repro_torch.cohort.state import DeviceCohortState
from repro_torch.cohort.tasks import CohortLogRegTask

__all__ = ["CohortLogRegTask", "DeviceCohortEngine", "DeviceCohortSimulator",
           "DeviceCohortState", "as_cohort_task", "make_simulator",
           "resolve_device"]
