"""Round-completion DP over a client cohort: clip, noise, accumulate.

CUDA kernels ``csrc/cohort_dp.cu`` (launched by ``kernel.py``) with
plain PyTorch versions (``ref.py``); ``ops.py`` dispatches by device.
The noise comes from an operand (``cohort_clip_noise``) or is generated
in the kernel from the tick's key (``cohort_clip_noise_prng``).
"""
from repro_torch.kernels.cohort_dp.ops import (cohort_clip_noise,
                                               cohort_clip_noise_prng)
from repro_torch.kernels.cohort_dp.ref import (cohort_clip_noise_prng_ref,
                                               cohort_clip_noise_ref,
                                               counter_normals)

__all__ = ["cohort_clip_noise", "cohort_clip_noise_prng",
           "cohort_clip_noise_prng_ref", "cohort_clip_noise_ref",
           "counter_normals"]
