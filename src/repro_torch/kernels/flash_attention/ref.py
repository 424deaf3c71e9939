"""Plain PyTorch version of the flash attention kernel, op for op the
reference's ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """q: (B,S,H,hd); k/v: (B,S,KV,hd) -> (B,S,H,hd).  Dense reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.to(torch.float32).reshape(B, S, KV, group, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (rows - cols < window)
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd).to(q.dtype)
