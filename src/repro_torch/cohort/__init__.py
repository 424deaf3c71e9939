"""The cohort engines: the whole client population as ``[C, D]`` blocks,
the paper's protocol tick by tick — the host-loop engine (``engine.py``,
Python control flow per tick) and the device-resident one
(``device.py``, the integer protocol on the card too)."""
from repro_torch.cohort.device import DeviceCohortEngine, resolve_device
from repro_torch.cohort.engine import CohortEngine
from repro_torch.cohort.flat import CohortBatchModelTask, PyTreeFlattener
from repro_torch.cohort.simulator import (CohortSimulator,
                                          DeviceCohortSimulator,
                                          as_cohort_task, make_simulator)
from repro_torch.cohort.state import (BroadcastRing, CohortState,
                                      DeviceCohortState, UpdateBuckets)
from repro_torch.cohort.tasks import CohortLogRegTask

__all__ = ["BroadcastRing", "CohortBatchModelTask", "CohortEngine",
           "CohortLogRegTask", "CohortSimulator", "CohortState",
           "DeviceCohortEngine", "DeviceCohortSimulator", "DeviceCohortState",
           "PyTreeFlattener", "UpdateBuckets", "as_cohort_task",
           "make_simulator", "resolve_device"]
