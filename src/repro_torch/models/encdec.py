"""Whisper-style encoder-decoder backbone.

The port's copy of ``repro.models.encdec``.  The mel-spectrogram + conv
feature extractor is a stub: ``encoder_embeds`` (B, S_enc, d_model)
arrive precomputed.  The encoder adds sinusoidal positions and runs
bidirectional attention through ``_scores_to_out`` with a full mask, as
the reference does (not the kernel); the decoder is causal self-attention
(``attend_full``: the ``flash_attention`` kernel on a CUDA tensor unless
``attn_core`` says otherwise) + cross-attention + MLP.  Layers run in a
Python loop over the stacked params; with ``remat`` on (the default)
and grad enabled each layer body is checkpointed
(``transformer.rematerialized``), as the reference's ``jax.checkpoint``
does; ``unroll=`` is accepted and ignored, as in ``transformer``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, init_norm, normal_init,
                                       padded_vocab, sinusoidal_positions,
                                       unembed)
from repro_torch.models.transformer import (_stack_norm, chunked_loss, layer,
                                            layers, rematerialized)
from repro_torch.sharding.context import constrain


def init_encdec(cfg, key, dtype, device=None):
    ks = prng.split(key, 12)
    d = cfg.d_model
    Vp = padded_vocab(cfg.vocab_size)
    params = {"embed": normal_init(ks[0], (Vp, d), dtype, device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal_init(ks[1], (Vp, d), dtype, device=device)

    Le = cfg.n_encoder_layers
    enc_cfg = dataclasses.replace(cfg, n_layers=Le)
    params["encoder"] = {
        "ln1": _stack_norm(cfg, ks[2], Le, d, dtype, device),
        "attn": attn.init_attention(enc_cfg, ks[3], dtype, device=device),
        "ln2": _stack_norm(cfg, ks[4], Le, d, dtype, device),
        "mlp": mlp_mod.init_mlp(cfg, ks[5], dtype, n_layers=Le,
                                device=device),
    }
    params["encoder_final_norm"] = init_norm(cfg, ks[6], d, dtype,
                                             device=device)

    L = cfg.n_layers
    params["decoder"] = {
        "ln1": _stack_norm(cfg, ks[7], L, d, dtype, device),
        "self_attn": attn.init_attention(cfg, ks[8], dtype, device=device),
        "ln_x": _stack_norm(cfg, ks[9], L, d, dtype, device),
        "cross_attn": attn.init_attention(cfg, ks[9], dtype, cross=True,
                                          device=device),
        "ln2": _stack_norm(cfg, ks[10], L, d, dtype, device),
        "mlp": mlp_mod.init_mlp(cfg, ks[10], dtype, device=device),
    }
    params["final_norm"] = init_norm(cfg, ks[11], d, dtype, device=device)
    return params


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def encode(cfg, params, encoder_embeds, *, remat: bool = True,
           unroll: bool = False):
    """encoder_embeds: (B, S_enc, d) from the conv/mel stub."""
    B, S, d = encoder_embeds.shape
    dev = encoder_embeds.device
    pe = sinusoidal_positions(S, d, device=dev).to(encoder_embeds.dtype)
    x = constrain(encoder_embeds + pe[None])
    positions = _positions(B, S, dev)
    full = torch.ones((1, 1, S, S), dtype=torch.bool, device=dev)

    def body(x, lp):
        h = apply_norm(cfg, x, lp["ln1"])
        q, k, v = attn._project_qkv(cfg, lp["attn"], h, positions, rope=False)
        o = attn._scores_to_out(cfg, q, k, v, full)
        o = torch.einsum("bsq,qd->bsd", o.reshape(B, S, -1), lp["attn"]["wo"])
        x = x + o
        h2 = apply_norm(cfg, x, lp["ln2"])
        return constrain(x + mlp_mod.apply_mlp(cfg, lp["mlp"], h2))

    body = rematerialized(body, remat)
    for lp in layers(params["encoder"]):
        x = body(x, lp)
    return apply_norm(cfg, x, params["encoder_final_norm"])


def _decoder_embed(cfg, params, tokens):
    S = tokens.shape[1]
    x = params["embed"][tokens]
    pe = sinusoidal_positions(max(S, 1), cfg.d_model,
                              device=x.device).to(x.dtype)
    return x + pe[None, :S]


def decode_full(cfg, params, tokens, enc_out, *, remat: bool = True,
                unroll: bool = False, attn_core: Optional[Callable] = None):
    """Teacher-forced decoder pass.  tokens (B,S_dec)."""
    B, S = tokens.shape
    x = constrain(_decoder_embed(cfg, params, tokens))
    positions = _positions(B, S, x.device)

    def body(x, lp, enc_out):
        h = apply_norm(cfg, x, lp["ln1"])
        x = x + attn.attend_full(cfg, lp["self_attn"], h, positions,
                                 rope=False, core=attn_core)
        hx = apply_norm(cfg, x, lp["ln_x"])
        ek, ev = attn.project_cross_kv(cfg, lp["cross_attn"], enc_out)
        x = x + attn.cross_attend(cfg, lp["cross_attn"], hx, ek, ev)
        h2 = apply_norm(cfg, x, lp["ln2"])
        return constrain(x + mlp_mod.apply_mlp(cfg, lp["mlp"], h2))

    body = rematerialized(body, remat)
    for lp in layers(params["decoder"]):
        x = body(x, lp, enc_out)
    return apply_norm(cfg, x, params["final_norm"])


def train_loss(cfg, params, batch, *, remat: bool = True,
               unroll: bool = False, attn_core: Optional[Callable] = None):
    """batch: {"tokens": (B,S_dec), "encoder_embeds": (B,S_enc,d)}."""
    enc_out = encode(cfg, params, batch["encoder_embeds"], remat=remat,
                     unroll=unroll)
    tokens = batch["tokens"]
    hidden = decode_full(cfg, params, tokens[:, :-1], enc_out, remat=remat,
                         unroll=unroll, attn_core=attn_core)
    mask = batch.get("mask")
    return chunked_loss(cfg, params, hidden, tokens[:, 1:],
                        None if mask is None else mask[:, 1:], unroll=unroll)


# ---------------------------------------------------------------------------
# Decode with cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, dtype, device=None):
    kv = attn.init_kv_cache(cfg, batch, cache_len, dtype, device=device)
    cross_shape = (cfg.n_layers, batch, cfg.encoder_seq_len,
                   cfg.n_kv_heads, cfg.head_dim)
    dev = kv["k"].device
    return {"kv": kv,
            "cross_k": torch.zeros(cross_shape, dtype=dtype, device=dev),
            "cross_v": torch.zeros(cross_shape, dtype=dtype, device=dev)}


def prime_cross_cache(cfg, params, cache, enc_out):
    """Fill per-layer cross K/V once after encoding."""
    kvs = [attn.project_cross_kv(cfg, layer(params["decoder"]["cross_attn"],
                                            li), enc_out)
           for li in range(cfg.n_layers)]
    return dict(cache, cross_k=torch.stack([k for k, _ in kvs]),
                cross_v=torch.stack([v for _, v in kvs]))


def serve_step(cfg, params, cache, tokens, pos: int, *, seq_len: int,
               unroll: bool = False):
    pos = int(pos)
    x = _decoder_embed_pos(cfg, params, tokens, pos)
    ks, vs = [], []
    for li in range(cfg.n_layers):
        lp = layer(params["decoder"], li)
        h = apply_norm(cfg, x, lp["ln1"])
        o, nk, nv = attn.decode_attend(cfg, lp["self_attn"], h,
                                       cache["kv"]["k"][li],
                                       cache["kv"]["v"][li], pos, None,
                                       rope=False)
        x = x + o
        hx = apply_norm(cfg, x, lp["ln_x"])
        x = x + attn.cross_attend(cfg, lp["cross_attn"], hx,
                                  cache["cross_k"][li], cache["cross_v"][li])
        h2 = apply_norm(cfg, x, lp["ln2"])
        x = x + mlp_mod.apply_mlp(cfg, lp["mlp"], h2)
        ks.append(nk)
        vs.append(nv)
    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)
    return logits, dict(cache, kv={"k": torch.stack(ks),
                                   "v": torch.stack(vs)})


def _decoder_embed_pos(cfg, params, tokens, pos: int):
    x = params["embed"][tokens]
    # sinusoidal position for a single position
    d = cfg.d_model
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
    inv = torch.exp(-math.log(10_000.0) * dim / d)
    ang = float(pos) * inv
    pe = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]
    return x + pe.to(x.dtype)
