"""Mamba-2 SSD chunked scan: ``y`` and the final state of the recurrence.

CUDA kernels ``csrc/ssd_scan.cu`` (four phases, launched by
``kernel.py``) with their plain PyTorch versions (``ref.py``: the
chunked SSD of the reference's ``models/ssm.py``, phase by phase);
``ops.py`` dispatches by device.
"""
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_cb, ssd_chunk_outputs,
                                              ssd_chunk_states, ssd_chunked,
                                              ssd_chunks, ssd_ref,
                                              ssd_state_passing)

__all__ = ["ssd", "ssd_scan", "ssd_chunked", "ssd_ref", "ssd_chunks",
           "ssd_cb", "ssd_chunk_states", "ssd_state_passing",
           "ssd_chunk_outputs"]
