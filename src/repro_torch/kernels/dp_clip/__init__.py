"""Per-example clip and accumulate for DP-SGD: ``(N, D) -> (D,)``.

CUDA kernel ``csrc/dp_clip.cu`` (launched by ``kernel.py``) with its
plain PyTorch version (``ref.py``; ``clip_accumulate_twin`` also
repeats the kernel's add order, so on the CPU it gives the kernel's
bits); ``ops.py`` dispatches by device.
"""
from repro_torch.kernels.dp_clip.ops import (clip_accumulate,
                                             clip_accumulate_tree)
from repro_torch.kernels.dp_clip.ref import (clip_accumulate_ref,
                                             clip_accumulate_twin)

__all__ = ["clip_accumulate", "clip_accumulate_tree", "clip_accumulate_ref",
           "clip_accumulate_twin"]
