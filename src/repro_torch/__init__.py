"""PyTorch/CUDA port of the asynchronous-FL reproduction (``repro``).

The paper's protocol (increasing round sizes, diminishing round step
sizes, the ``d`` wait gate, round-level Gaussian DP noise) on the
reference's three engines — the device-resident and host-loop cohort
engines, whose per-tick ``[C, D]`` work runs in hand-written CUDA kernels
(``repro_torch.kernels``, sources in ``csrc/``), and the discrete-event
simulator (``make_simulator`` switches) — the paper's Theorem-4
accountant (``repro_torch.dp``), and the reference's model API and serve
driver (``repro_torch.models``, ``repro_torch.launch.serve``), whose
attention and Mamba-2 layers run through the same kind of kernels.
The port imports torch, numpy and the standard library only; it is
checked against the JAX reference by the tests, which import both.
"""
from repro_torch.cohort import (CohortEngine, CohortSimulator,
                                DeviceCohortEngine, DeviceCohortSimulator,
                                make_simulator)
from repro_torch.core import AsyncFLSimulator, LogRegTask, run_sync_baseline
from repro_torch.data import make_binary_dataset

__all__ = ["AsyncFLSimulator", "CohortEngine", "CohortSimulator",
           "DeviceCohortEngine", "DeviceCohortSimulator", "LogRegTask",
           "make_binary_dataset", "make_simulator", "run_sync_baseline"]
