"""Mamba-2 SSD chunked scan: ``y`` and the final state of the recurrence.

CUDA kernel ``csrc/ssd_scan.cu`` (launched by ``kernel.py``) with its
plain PyTorch version (``ref.py``: the chunked SSD of the reference's
``models/ssm.py``); ``ops.py`` dispatches by device.
"""
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked, ssd_ref

__all__ = ["ssd", "ssd_scan", "ssd_chunked", "ssd_ref"]
