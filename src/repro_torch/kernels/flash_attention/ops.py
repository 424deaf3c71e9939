"""Dispatch for the flash attention kernel: by the tensors' device.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version (``attention_ref``).  The kernel has no
backward: on the card an input that requires grad, in grad mode,
raises.  The kernel masks the ragged edge of the sequence instead of
padding it, so for ``causal=False`` it matches ``attention_ref`` where
the reference's padded ``attend`` lets the zero keys of its padding into
the softmax.

The kernel is also the custom op ``torch.ops.repro_torch.flash_attention``
(its CUDA implementation is the launcher), which a tensor subclass on
the card — a fake tensor of the dry run, a DTensor — goes through, so
that fake tensors (``register_fake``), ``FlopCounterMode`` (``flops``,
the kernel's own work: the unmasked query-key pairs) and DTensor
(``register_sharding_rule``: batch and heads may be sharded, sequence
and head dim stay whole) can trace it without a data pointer.  A plain
CUDA tensor calls the launcher directly.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.tick_fused.ops import no_backward, on_cuda


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       softcap: Optional[float]) -> torch.Tensor:
    return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                  softcap=softcap)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, softcap):
    return q.new_empty(q.shape)


def attended_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """Query-key pairs a (causal, window) mask keeps over length S."""
    if not causal:
        return S * S
    W = S if window is None else min(int(window), S)
    return W * (W + 1) // 2 + (S - W) * W


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flops(q_shape, k_shape, v_shape, causal, window, softcap, *args,
          out_shape=None, **kwargs) -> int:
    """2·hd for q·k and 2·hd for p·v per kept pair and query head."""
    B, S, H, hd = q_shape
    return 4 * B * H * hd * attended_pairs(S, causal, window)


def register_sharding_rule() -> None:
    """Tell DTensor how the op shards: replicated, or q/k/v/out all
    sharded on batch (dim 0), or all on heads (dim 2) where both head
    counts divide over every mesh dim (GQA groups stay whole)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal, window, softcap):
        rest = [None, None, None]
        out = [([Replicate()], [Replicate()] * 3 + rest),
               ([Shard(0)], [Shard(0)] * 3 + rest)]
        m = max(q.mesh.shape)
        if q.shape[2] % m == 0 and k.shape[2] % m == 0:
            out.append(([Shard(2)], [Shard(2)] * 3 + rest))
        return out


def attend(q, k, v, *, causal: bool = True, window: Optional[int] = None,
           softcap: Optional[float] = None):
    """q: (B,S,H,hd); k/v: (B,S,KV,hd) -> (B,S,H,hd) in q's dtype."""
    if not on_cuda(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    no_backward("flash_attention", q, k, v)
    k, v = k.to(q.dtype), v.to(q.dtype)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if type(q) is torch.Tensor:
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                 softcap)
