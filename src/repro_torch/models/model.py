"""Model API: family dispatch for init / train_loss / serve_step.

The port's copy of ``repro.models.model``.  All architectures expose:
    init_params(cfg, key, dtype, device)         -> params (nested dicts)
    train_loss(cfg, params, batch, remat=True)   -> scalar loss (f32)
    forward_prefill(cfg, params, batch)          -> last-position logits
    init_cache(cfg, batch, cache_len, dtype, device) -> decode cache
    serve_step(cfg, params, cache, tokens, pos, seq_len) -> (logits, cache)

``device=None`` means the card (and raises without CUDA); the other
functions run where their tensors are.  ``attn_core`` / ``ssd_fn`` choose
the attention and SSD cores of the full-sequence passes (None: the
kernels' routes; see ``transformer``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.common import unembed

_DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _family(cfg) -> str:
    if cfg.family in _DECODER_FAMILIES:
        return "decoder"
    if cfg.family == "encdec":
        return "encdec"
    raise ValueError(f"unknown family {cfg.family!r}")


def init_params(cfg, key, dtype=torch.bfloat16, device=None):
    if _family(cfg) == "decoder":
        return transformer.init_decoder(cfg, key, dtype, device=device)
    return encdec.init_encdec(cfg, key, dtype, device=device)


def train_loss(cfg, params, batch, *, remat: bool = True,
               unroll: bool = False, attn_core: Optional[Callable] = None,
               ssd_fn=None):
    if _family(cfg) == "decoder":
        return transformer.train_loss(cfg, params, batch, remat=remat,
                                      unroll=unroll, attn_core=attn_core,
                                      ssd_fn=ssd_fn)
    return encdec.train_loss(cfg, params, batch, remat=remat, unroll=unroll,
                             attn_core=attn_core)


def forward_prefill(cfg, params, batch, *, remat: bool = True,
                    unroll: bool = False,
                    attn_core: Optional[Callable] = None, ssd_fn=None):
    """Prefill pass: returns last-position logits (B, V)."""
    if _family(cfg) == "decoder":
        hidden, _ = transformer.forward(cfg, params, batch["tokens"],
                                        remat=remat, unroll=unroll,
                                        attn_core=attn_core, ssd_fn=ssd_fn)
    else:
        enc_out = encdec.encode(cfg, params, batch["encoder_embeds"],
                                remat=remat, unroll=unroll)
        hidden = encdec.decode_full(cfg, params, batch["tokens"], enc_out,
                                    remat=remat, unroll=unroll,
                                    attn_core=attn_core)
    return unembed(cfg, params, hidden[:, -1])


def init_cache(cfg, batch, cache_len, dtype=torch.bfloat16, device=None):
    if _family(cfg) == "decoder":
        return transformer.init_cache(cfg, batch, cache_len, dtype,
                                      device=device)
    return encdec.init_cache(cfg, batch, cache_len, dtype, device=device)


def serve_step(cfg, params, cache, tokens, pos: int, *, seq_len: int,
               unroll: bool = False):
    if _family(cfg) == "decoder":
        return transformer.serve_step(cfg, params, cache, tokens, pos,
                                      seq_len=seq_len, unroll=unroll)
    return encdec.serve_step(cfg, params, cache, tokens, pos,
                             seq_len=seq_len, unroll=unroll)
