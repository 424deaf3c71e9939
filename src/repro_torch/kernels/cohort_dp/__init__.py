"""Round-completion DP over a client cohort: clip, noise, accumulate.

CUDA kernel ``csrc/cohort_dp.cu`` (launched by ``kernel.py``) with a
plain PyTorch version (``ref.py``); ``ops.py`` dispatches by device.
"""
from repro_torch.kernels.cohort_dp.ops import cohort_clip_noise
from repro_torch.kernels.cohort_dp.ref import cohort_clip_noise_ref

__all__ = ["cohort_clip_noise", "cohort_clip_noise_ref"]
