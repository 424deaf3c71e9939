"""Unified decoder backbone for dense / moe / ssm / hybrid / vlm families.

The port's copy of ``repro.models.transformer``.  Per-layer params are
stacked on a leading axis as in the reference; the layers run in a Python
loop over that axis (``layer``), the reference's ``unroll=True`` form of
its ``lax.scan``.  Per-layer heterogeneity such as gemma2's local/global
alternation is a per-layer ``window`` (``layer_windows``).

``remat=True`` (the default, as the reference's) runs each layer body,
or each (local, global) pair under ``REPRO_CHUNKED_LOCAL``, through
``torch.utils.checkpoint`` when grad is enabled: the body's activations
are dropped after the forward and the body runs again in backward, as
the reference's ``jax.checkpoint`` does.  The training step
differentiates the plain cores (``attn_core`` / ``ssd_fn``), so without
it every layer's activations would stay alive until backward.  Each
loss chunk's unembed, ``log_softmax`` and gather are checkpointed
whatever ``remat`` says (the reference's ``@jax.checkpoint one``).
Under ``no_grad`` (prefill, metrics) nothing is checkpointed.  The
bodies draw no random numbers, so no RNG state is kept for the rerun.
``unroll=`` is accepted and ignored: eager PyTorch has no scan to
unroll.  The reference's sharding hooks (``constrain``,
``shard_layer_param_cotangents``) sit where the reference calls them,
inside the checkpointed bodies; they act only on DTensors under a spec
the dry run installs (``repro_torch.sharding.context``), are installed
again for the rerun, and are the identity otherwise.

Kernels: ``forward`` runs each attention layer through ``attend_full``
with ``attn_core`` (None: the ``flash_attention`` kernel on a CUDA
tensor, its plain version on a CPU one) and each mixer through
``apply_ssm`` with ``ssd_fn`` (None: the ``ssd_scan`` kernel, likewise);
``attn_core=attention.dense_attention`` / ``ssd_fn=ssm.ssd_chunked``
run the same model through the plain cores on any device.  Decode
(``serve_step``) is plain torch, as it is plain jnp in the reference.

Loss materialization: logits for 256k vocabularies are never
materialized for the full sequence — cross entropy runs in sequence
chunks.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import prng, tree
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, embed_tokens, init_norm,
                                       normal_init, padded_vocab, unembed)
from repro_torch.sharding.context import (constrain, installed_specs,
                                          shard_layer_param_cotangents,
                                          use_specs)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_decoder(cfg, key, dtype, device=None):
    ks = prng.split(key, 8)
    Vp = padded_vocab(cfg.vocab_size)
    params = {"embed": normal_init(ks[0], (Vp, cfg.d_model), dtype,
                                   device=device)}
    if not cfg.tie_embeddings:
        params["unembed"] = normal_init(ks[1], (Vp, cfg.d_model), dtype,
                                        device=device)

    blocks = {}
    L, d = cfg.n_layers, cfg.d_model
    blocks["ln1"] = _stack_norm(cfg, ks[2], L, d, dtype, device)
    if cfg.family != "ssm":
        blocks["attn"] = attn.init_attention(cfg, ks[3], dtype, device=device)
        blocks["ln2"] = _stack_norm(cfg, ks[4], L, d, dtype, device)
        if cfg.post_attn_norm:
            blocks["post_attn"] = _stack_norm(cfg, ks[4], L, d, dtype, device)
            blocks["post_mlp"] = _stack_norm(cfg, ks[5], L, d, dtype, device)
        if cfg.n_experts:
            blocks["moe"] = moe_mod.init_moe(cfg, ks[5], dtype, device=device)
        else:
            blocks["mlp"] = mlp_mod.init_mlp(cfg, ks[5], dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        blocks["ssm"] = ssm_mod.init_ssm(cfg, ks[6], dtype, device=device)
    params["blocks"] = blocks
    params["final_norm"] = init_norm(cfg, ks[7], d, dtype, device=device)
    return params


def _stack_norm(cfg, key, L, d, dtype, device=None):
    one = init_norm(cfg, key, d, dtype, device=device)
    return {k: a.expand((L,) + tuple(a.shape)).contiguous()
            for k, a in one.items()}


def layer(blocks, i: int):
    """Layer ``i`` of a stacked ``(L, ...)`` params (or cache) tree."""
    return tree.tree_map(lambda a: a[i], blocks)


def layers(blocks) -> List:
    """Every layer of a stacked ``(L, ...)`` tree, as views from one
    ``unbind`` per leaf: its backward writes each stacked gradient once,
    where a ``layer(blocks, i)`` per layer would write it L times (each
    select's backward a full (L, ...) tensor of zeros)."""
    flat = [torch.unbind(a) for a in tree.leaves(blocks)]
    return [tree.unflatten(blocks, [u[i] for u in flat])
            for i in range(len(flat[0]))]


def layer_windows(cfg, seq_len: int) -> List[int]:
    """Effective attention window per layer (``seq_len`` == full)."""
    out = []
    for i in range(cfg.n_layers):
        if cfg.sliding_window is not None and cfg.layer_is_local(i):
            out.append(min(cfg.sliding_window, seq_len))
        else:
            out.append(seq_len)
    return out


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _layer_body(cfg, x, lp, window, positions, *, unroll=False,
                chunked_local_window: Optional[int] = None,
                attn_core: Optional[Callable] = None, ssd_fn=None):
    """One decoder layer.  x: (B,S,d).

    chunked_local_window: when set, the layer uses the block-local
    attention path (computes only window-adjacent chunks).
    """
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = apply_norm(cfg, x, lp["ln1"])
    if cfg.family == "ssm":
        x = x + ssm_mod.apply_ssm(cfg, lp["ssm"], h, ssd_fn=ssd_fn)
        return x, aux
    if chunked_local_window is not None:
        attn_out = attn.attend_chunked(cfg, lp["attn"], h, positions,
                                       chunked_local_window)
    else:
        attn_out = attn.attend_full(cfg, lp["attn"], h, positions, window,
                                    core=attn_core)
    if cfg.family == "hybrid":
        ssm_out = ssm_mod.apply_ssm(cfg, lp["ssm"], h, ssd_fn=ssd_fn)
        attn_out = 0.5 * (attn_out + ssm_out)
    if cfg.post_attn_norm:
        attn_out = apply_norm(cfg, attn_out, lp["post_attn"])
    x = x + attn_out
    h2 = apply_norm(cfg, x, lp["ln2"])
    if cfg.n_experts:
        ff, aux = moe_mod.apply_moe(cfg, lp["moe"], h2)
    else:
        ff = mlp_mod.apply_mlp(cfg, lp["mlp"], h2)
    if cfg.post_attn_norm:
        ff = apply_norm(cfg, ff, lp["post_mlp"])
    x = x + ff
    return x, aux


def rematerialized(fn, remat: bool = True):
    """``fn`` as ``jax.checkpoint(fn)``: when ``remat`` is on and grad is
    enabled, a call keeps only its inputs and runs ``fn`` again in
    backward (``torch.utils.checkpoint``, non-reentrant), with the
    sharding specs installed at the call installed again; else ``fn``."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    specs = installed_specs()

    def again(*args):
        with use_specs(specs):
            return fn(*args)

    return lambda *args: checkpoint(again, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def forward(cfg, params, tokens, *, remat: bool = True,
            positions: Optional[torch.Tensor] = None, unroll: bool = False,
            attn_core: Optional[Callable] = None, ssd_fn=None):
    """tokens (B,S) -> final hidden states (B,S,d) and aux loss.

    ``REPRO_CHUNKED_LOCAL=1`` (read at call time, as the reference reads
    it) runs (local, global) layer pairs, the local layer through the
    block-local path, when the config alternates and S > 2 * window."""
    B, S = tokens.shape
    x = constrain(embed_tokens(cfg, params, tokens))
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    windows = layer_windows(cfg, S)
    aux = torch.zeros((), dtype=F32, device=x.device)
    kw = dict(unroll=unroll, attn_core=attn_core, ssd_fn=ssd_fn)

    chunked_local = (
        os.environ.get("REPRO_CHUNKED_LOCAL") == "1"
        and cfg.sliding_window is not None
        and cfg.local_global_period == 2
        and cfg.n_layers % 2 == 0
        and S > 2 * cfg.sliding_window)

    lps = layers(params["blocks"])
    if chunked_local:
        W = int(cfg.sliding_window)

        def pair_body(x, lp_loc, lp_glb):
            lp_loc = shard_layer_param_cotangents(lp_loc)
            lp_glb = shard_layer_param_cotangents(lp_glb)
            x, a1 = _layer_body(cfg, x, lp_loc, None, positions,
                                chunked_local_window=W, **kw)
            x = constrain(x)
            x, a2 = _layer_body(cfg, x, lp_glb, S, positions, **kw)
            return constrain(x), a1, a2

        pair_body = rematerialized(pair_body, remat)
        for pi in range(cfg.n_layers // 2):
            x, a1, a2 = pair_body(x, lps[2 * pi], lps[2 * pi + 1])
            aux = aux + a1 + a2
    else:
        def body(x, lp, window):
            lp = shard_layer_param_cotangents(lp)
            x, a = _layer_body(cfg, x, lp, window, positions, **kw)
            return constrain(x), a

        body = rematerialized(body, remat)
        for li, lp in enumerate(lps):
            x, a = body(x, lp, windows[li])
            aux = aux + a
    x = apply_norm(cfg, x, params["final_norm"])
    return x, aux


def _pad_seq(t, pad: int):
    """``t`` (B, S, ...) with ``pad`` zero positions appended."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                     dim=1)


def chunked_loss(cfg, params, hidden, labels, mask=None, chunk: int = 512,
                 unroll: bool = False):
    """Cross entropy over sequence chunks (never materializes (B,S,V))."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        hidden = _pad_seq(hidden, pad)
        labels = _pad_seq(labels, pad)
        if mask is None:   # ones over the S positions, zeros over the pad
            mask = (torch.arange(S + pad, device=labels.device) < S).to(
                labels.dtype).expand(labels.shape)
        else:
            mask = _pad_seq(mask, pad)
        S = S + pad
    if mask is None:
        mask = torch.ones_like(labels)

    def one(h_c, y_c, m_c):
        logits = unembed(cfg, params, h_c)
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, y_c[..., None].to(torch.int64))[..., 0]
        m = m_c.to(F32)
        return torch.sum(-ll * m), torch.sum(m)

    one = rematerialized(one)
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    for lo in range(0, S, chunk):
        l, c = one(hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk],
                   mask[:, lo:lo + chunk])
        tot = tot + l
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(cfg, params, batch, *, remat: bool = True,
               unroll: bool = False, attn_core: Optional[Callable] = None,
               ssd_fn=None):
    """Next-token LM loss.  batch: {"tokens": (B,S)} (+ optional mask)."""
    tokens = batch["tokens"]
    hidden, aux = forward(cfg, params, tokens[:, :-1], remat=remat,
                          unroll=unroll, attn_core=attn_core, ssd_fn=ssd_fn)
    labels = tokens[:, 1:]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask[:, 1:]
    loss = chunked_loss(cfg, params, hidden, labels, mask, unroll=unroll)
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux / cfg.n_layers
    return loss


# ---------------------------------------------------------------------------
# Decode (single token) over the stacked caches, layer by layer
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, cache_len: int, dtype, device=None):
    cache = {}
    if cfg.family != "ssm":
        cache["kv"] = attn.init_kv_cache(cfg, batch, cache_len, dtype,
                                         device=device)
    if cfg.family in ("ssm", "hybrid"):
        cache["ssm"] = ssm_mod.init_ssm_state(cfg, batch, device=device)
    return cache


def _decode_layer(cfg, x, lp, window, layer_cache, pos, *, seq_len, ring,
                  quantized):
    """One decoder layer of ``serve_step``: (x, this layer's new cache)."""
    h = apply_norm(cfg, x, lp["ln1"])
    new_cache = {}
    if cfg.family == "ssm":
        out, new_h, new_conv = ssm_mod.decode_ssm(
            cfg, lp["ssm"], h, layer_cache["ssm_h"], layer_cache["ssm_conv"])
        new_cache.update(ssm_h=new_h, ssm_conv=new_conv)
        return x + out, new_cache
    eff_window = min(window, seq_len)
    if quantized:
        a_out, qc = attn.decode_attend_quantized(
            cfg, lp["attn"], h,
            {k: layer_cache[k] for k in ("k", "v", "k_scale", "v_scale")},
            pos, eff_window, ring=ring)
        new_cache.update(qc)
    else:
        a_out, nk, nv = attn.decode_attend(
            cfg, lp["attn"], h, layer_cache["k"], layer_cache["v"], pos,
            eff_window, ring=ring)
        new_cache.update(k=nk, v=nv)
    if cfg.family == "hybrid":
        s_out, new_h, new_conv = ssm_mod.decode_ssm(
            cfg, lp["ssm"], h, layer_cache["ssm_h"], layer_cache["ssm_conv"])
        new_cache.update(ssm_h=new_h, ssm_conv=new_conv)
        a_out = 0.5 * (a_out + s_out)
    if cfg.post_attn_norm:
        a_out = apply_norm(cfg, a_out, lp["post_attn"])
    x = x + a_out
    h2 = apply_norm(cfg, x, lp["ln2"])
    if cfg.n_experts:
        ff, _ = moe_mod.apply_moe(cfg, lp["moe"], h2, capacity_factor=2.0)
    else:
        ff = mlp_mod.apply_mlp(cfg, lp["mlp"], h2)
    if cfg.post_attn_norm:
        ff = apply_norm(cfg, ff, lp["post_mlp"])
    return x + ff, new_cache


def serve_step(cfg, params, cache, tokens, pos: int, *, seq_len: int,
               unroll: bool = False):
    """Decode one token.  tokens (B,1); pos a host int (a 0-d tensor is
    read with ``int``, a sync when it lies on the card).

    ``seq_len`` is the logical max sequence; ring buffering activates when
    the allocated cache is shorter (windowed long-context decode).
    Returns (logits (B,1,V) f32, the new cache; the old one is left as
    it was).
    """
    pos = int(pos)
    x = embed_tokens(cfg, params, tokens)
    windows = layer_windows(cfg, seq_len)

    ring = quantized = False
    layer_cache = {}
    if "kv" in cache:
        ring = cache["kv"]["k"].shape[2] < seq_len
        quantized = "k_scale" in cache["kv"]
        for name in (("k", "v", "k_scale", "v_scale") if quantized
                     else ("k", "v")):
            layer_cache[name] = cache["kv"][name]
    if "ssm" in cache:
        layer_cache["ssm_h"] = cache["ssm"]["h"]
        layer_cache["ssm_conv"] = cache["ssm"]["conv"]

    updates = []
    for li in range(cfg.n_layers):
        x, upd = _decode_layer(cfg, x, layer(params["blocks"], li),
                               windows[li], layer(layer_cache, li), pos,
                               seq_len=seq_len, ring=ring,
                               quantized=quantized)
        updates.append(upd)
    new_layer_cache = {k: torch.stack([u[k] for u in updates])
                       for k in updates[0]}

    new_cache = {}
    if "kv" in cache:
        new_cache["kv"] = {k: new_layer_cache[k] for k in layer_cache
                           if not k.startswith("ssm_")}
    if "ssm" in cache:
        new_cache["ssm"] = {"h": new_layer_cache["ssm_h"],
                            "conv": new_layer_cache["ssm_conv"]}

    x = apply_norm(cfg, x, params["final_norm"])
    logits = unembed(cfg, params, x)
    return logits, new_cache
