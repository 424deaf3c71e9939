"""PyTorch/CUDA port of the asynchronous-FL reproduction (``repro``).

The paper's protocol (increasing round sizes, diminishing round step
sizes, the ``d`` wait gate, round-level Gaussian DP noise) on the
device-resident cohort engine, with its per-tick ``[C, D]`` work in
hand-written CUDA kernels (``repro_torch.kernels``, sources in
``csrc/``).  The port imports torch, numpy and the standard library only;
it is checked against the JAX reference by the tests, which import both.
"""
from repro_torch.cohort import (DeviceCohortEngine, DeviceCohortSimulator,
                                make_simulator)
from repro_torch.core import LogRegTask
from repro_torch.data import make_binary_dataset

__all__ = ["DeviceCohortEngine", "DeviceCohortSimulator", "LogRegTask",
           "make_binary_dataset", "make_simulator"]
