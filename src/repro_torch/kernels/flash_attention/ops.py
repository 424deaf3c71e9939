"""Dispatch for the flash attention kernel: by the tensors' device.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version (``attention_ref``).  The kernel has no
backward: on the card an input that requires grad, in grad mode,
raises.  The kernel masks the ragged edge of the sequence instead of
padding it, so for ``causal=False`` it matches ``attention_ref`` where
the reference's padded ``attend`` lets the zero keys of its padding into
the softmax.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tick_fused.ops import no_backward, on_cuda


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           softcap: Optional[float] = None):
    """q: (B,S,H,hd); k/v: (B,S,KV,hd) -> (B,S,H,hd) in q's dtype."""
    if not on_cuda(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    no_backward("flash_attention", q, k, v)
    k, v = k.to(q.dtype), v.to(q.dtype)
    return flash_attention_kernel(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, softcap=softcap)
