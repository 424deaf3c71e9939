"""The logistic-regression client block: every client's local SGD steps
of a block tick in one launch.

CUDA kernel ``csrc/cohort_block.cu`` (launched by ``kernel.py``) with its
plain twin (``ref.py``, the kernel's arithmetic and add order, so on CUDA
tensors it gives the kernel's bits); ``ops.py`` dispatches by device.
"""
from repro_torch.kernels.cohort_block.ops import logreg_block
from repro_torch.kernels.cohort_block.ref import lane_sum, logreg_block_ref

__all__ = ["lane_sum", "logreg_block", "logreg_block_ref"]
