"""Online-softmax attention: causal / sliding-window masks, logit softcap,
GQA.

CUDA kernel ``csrc/flash_attention.cu`` (launched by ``kernel.py``) with
its plain PyTorch version (``ref.py``); ``ops.py`` dispatches by device.
"""
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["attend", "attention_ref"]
