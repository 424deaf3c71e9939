"""Grouped-query attention with sliding-window, softcap, and KV-cache decode.

The port's copy of ``repro.models.attention``.  Two full-sequence paths:
  * ``attend_full``    — masked attention over the whole sequence; its
    core (scores -> softcap -> causal/window mask -> softmax -> PV) goes
    through ``repro_torch.kernels.flash_attention.ops.attend``: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor.  The
    reference's own core, the q-chunked masked dense path it calls the
    XLA stand-in for the flash kernel, is ``dense_attention``; a caller
    passes it as ``core`` to run the layer without the kernel;
  * ``attend_chunked`` — block-local attention that only computes the
    window-adjacent chunks (exact for a window <= chunk; plain torch).

Decode attends a single query token against a (ring-buffered) cache and
cross attention attends without a mask; neither is the kernel's
function (Sq != Sk, no mask), so both stay plain torch, as they are plain
jnp in the reference.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch import prng
from repro_torch.devices import resolve_device
from repro_torch.kernels.flash_attention.ops import attend
from repro_torch.models.common import apply_rope, expand_rank, fan_in_init

F32 = torch.float32
NEG_INF = -2.0 ** 30
# the reference's default query chunk of the dense path (REPRO_Q_CHUNK)
Q_CHUNK = 1024


def init_attention(cfg, key, dtype, *, cross: bool = False, device=None):
    d, q_dim = cfg.d_model, cfg.n_heads * cfg.head_dim
    kv_dim = cfg.n_kv_heads * cfg.head_dim
    ks = prng.split(key, 4)
    L = cfg.n_layers
    p = {
        "wq": fan_in_init(ks[0], (L, d, q_dim), dtype, device=device),
        "wk": fan_in_init(ks[1], (L, d, kv_dim), dtype, device=device),
        "wv": fan_in_init(ks[2], (L, d, kv_dim), dtype, device=device),
        "wo": fan_in_init(ks[3], (L, q_dim, d), dtype, device=device),
    }
    if cfg.qkv_bias:
        dev = resolve_device(device)
        p["bq"] = torch.zeros((L, q_dim), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((L, kv_dim), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((L, kv_dim), dtype=dtype, device=dev)
    return p


def _project_qkv(cfg, lp, x, positions, *, rope: bool = True):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dq->bsq", x, lp["wq"])
    k = torch.einsum("bsd,dk->bsk", x, lp["wk"])
    v = torch.einsum("bsd,dk->bsk", x, lp["wv"])
    if "bq" in lp:
        q = q + expand_rank(lp["bq"], q.dim())
        k = k + expand_rank(lp["bk"], k.dim())
        v = v + expand_rank(lp["bv"], v.dim())
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_out(q, k, v, mask, softcap: Optional[float]):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable (B,1,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    group = H // KV
    qg = q.reshape(B, Sq, KV, group, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(F32),
                          k.to(F32)) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(F32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _scores_to_out(cfg, q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd), mask broadcastable (B,1,Sq,Sk)."""
    return _masked_out(q, k, v, mask, cfg.attn_softcap)


def causal_mask(Sq: int, Sk: int, window, device=None) -> torch.Tensor:
    """(1,1,Sq,Sk) boolean; window None => full causal."""
    qi = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (qi - kj < window)
    return m[None, None]


def dense_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_chunk: int = Q_CHUNK):
    """The reference's own core of ``attend_full``: masked dense attention
    with the queries in chunks of ``q_chunk`` (bounding the score buffer
    to q_chunk x S), plain torch on any device.  Same contract as
    ``kernels.flash_attention.ops.attend``."""
    S = q.shape[1]
    kj = torch.arange(S, device=q.device)[None, :]
    outs = []
    for lo in range(0, S, q_chunk):
        qi = lo + torch.arange(min(q_chunk, S - lo), device=q.device)[:, None]
        m = kj <= qi if causal else torch.ones_like(kj <= qi)
        if window is not None:
            m = m & (qi - kj < window)
        outs.append(_masked_out(q[:, lo:lo + q_chunk], k, v, m[None, None],
                                softcap))
    return torch.cat(outs, dim=1)


def attend_full(cfg, lp, x, positions, window=None, *, rope=True,
                core: Optional[Callable] = None):
    """Masked causal attention over the full sequence.

    ``core(q, k, v, *, causal, window, softcap)`` computes scores ->
    softcap -> mask -> softmax -> PV; None means the flash attention
    kernel's route (``kernels.flash_attention.ops.attend``), which the
    reference names as what its q-chunked dense path stands in for;
    ``core=dense_attention`` is that dense path itself.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, lp, x, positions, rope=rope)
    core = attend if core is None else core
    out = core(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap)
    return torch.einsum("bsq,qd->bsd", out.reshape(B, S, -1), lp["wo"])


def attend_chunked(cfg, lp, x, positions, window: int, *, rope=True):
    """Block-local attention: queries in chunk c attend to chunks c-1, c.

    Requires S % window == 0 (else ``attend_full``).  Exact for any
    sliding window <= chunk size (chunk = window).  FLOPs: 2*S*W*d
    instead of S^2*d/2.
    """
    B, S, _ = x.shape
    W = window
    if S % W != 0:
        return attend_full(cfg, lp, x, positions, window, rope=rope)
    q, k, v = _project_qkv(cfg, lp, x, positions, rope=rope)
    C = S // W
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    qc = q.reshape(B, C, W, H, hd)
    kc = k.reshape(B, C, W, KV, hd)
    vc = v.reshape(B, C, W, KV, hd)
    # previous chunk (zero for c=0, masked out anyway)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kp, kc], dim=2)  # (B,C,2W,KV,hd)
    v2 = torch.cat([vp, vc], dim=2)

    group = H // KV
    qg = qc.reshape(B, C, W, KV, group, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bcqkgh,bcskh->bckgqs", qg.to(F32),
                          k2.to(F32)) * scale
    if cfg.attn_softcap is not None:
        scores = cfg.attn_softcap * torch.tanh(scores / cfg.attn_softcap)

    dev = x.device
    qi = torch.arange(W, device=dev)[:, None] + W  # position within 2W window
    kj = torch.arange(2 * W, device=dev)[None, :]
    mask = (kj <= qi) & (qi - kj < W)              # causal + window
    first = torch.arange(C, device=dev)[:, None, None] == 0
    valid = torch.where(first, kj[None] >= W, True)  # chunk 0 has no prev
    mask = mask[None] & valid                        # (C,W,2W)
    scores = torch.where(mask[None, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bckgqs,bcskh->bcqkgh", probs, v2.to(F32))
    out = out.reshape(B, S, H * hd).to(x.dtype)
    return torch.einsum("bsq,qd->bsd", out, lp["wo"])


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device=None):
    """dtype torch.int8 selects the quantized cache layout (per-(token,
    head) absmax scales in bf16)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=dev),
                "v_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def quantize_kv(x):
    """x: (..., hd) -> (int8 values, bf16 scales)."""
    amax = torch.amax(torch.abs(x.to(F32)), dim=-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x.to(F32) / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale):
    return q.to(F32) * scale.to(F32)[..., None]


def _cache_slot(pos: int, L_cache: int, ring: bool) -> int:
    return pos % L_cache if ring else min(pos, L_cache - 1)


def _slot_mask(slot: int, L_cache: int, device) -> torch.Tensor:
    """(1, L_cache, 1, 1) boolean, true at ``slot``: the new entry is
    written with ``torch.where`` (a fresh cache, the old one left as it
    was), which keeps a cache sharded along its length in place on a
    mesh, where an indexed write would gather it."""
    return (torch.arange(L_cache, device=device) == slot)[None, :, None,
                                                          None]


def _cache_mask(pos: int, slot: int, L_cache: int, window, ring: bool,
                device):
    idx = torch.arange(L_cache, device=device)
    if ring:
        # entry at idx holds logical position: reconstructed from ring layout
        logical = torch.where(idx <= slot, pos - (slot - idx),
                              pos - (slot + L_cache - idx))
        valid = logical >= 0
    else:
        logical = idx
        valid = idx <= pos
    if window is not None:
        valid = valid & (pos - logical < window)
    return valid[None, None, None, :]  # (1,1,1,L_cache)


def decode_attend(cfg, lp, x, cache_k, cache_v, pos: int, window=None, *,
                  rope=True, ring: bool = False):
    """One-token decode.  x: (B,1,d); cache_[kv]: (B,L_cache,KV,hd);
    pos: current position (int).  Returns (out (B,1,d), new_k, new_v).

    ring=True treats the cache as a ring buffer of size L_cache (used when
    the cache is smaller than the logical sequence, i.e. windowed decode).
    """
    B = x.shape[0]
    L_cache = cache_k.shape[1]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, lp, x, positions, rope=rope)
    slot = _cache_slot(pos, L_cache, ring)
    at = _slot_mask(slot, L_cache, x.device)
    cache_k = torch.where(at, k.to(cache_k.dtype), cache_k)
    cache_v = torch.where(at, v.to(cache_v.dtype), cache_v)

    mask = _cache_mask(pos, slot, L_cache, window, ring, x.device)
    out = _scores_to_out(cfg, q, cache_k, cache_v, mask)
    out = torch.einsum("bsq,qd->bsd", out.reshape(B, 1, -1), lp["wo"])
    return out, cache_k, cache_v


def decode_attend_quantized(cfg, lp, x, qcache, pos: int, window=None, *,
                            rope=True, ring: bool = False):
    """int8-KV decode: dequantize-on-read, quantize-on-write.

    qcache: {k, v: int8 (B,L,KV,hd); k_scale, v_scale: bf16 (B,L,KV)}.
    Returns (out, new_cache_dict).
    """
    B = x.shape[0]
    L_cache = qcache["k"].shape[1]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, lp, x, positions, rope=rope)

    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    slot = _cache_slot(pos, L_cache, ring)
    at = _slot_mask(slot, L_cache, x.device)
    new = {"k": torch.where(at, kq, qcache["k"]),
           "v": torch.where(at, vq, qcache["v"]),
           "k_scale": torch.where(at[..., 0], ks, qcache["k_scale"]),
           "v_scale": torch.where(at[..., 0], vs, qcache["v_scale"])}

    k_f = dequantize_kv(new["k"], new["k_scale"]).to(q.dtype)
    v_f = dequantize_kv(new["v"], new["v_scale"]).to(q.dtype)

    mask = _cache_mask(pos, slot, L_cache, window, ring, x.device)
    out = _scores_to_out(cfg, q, k_f, v_f, mask)
    out = torch.einsum("bsq,qd->bsd", out.reshape(B, 1, -1), lp["wo"])
    return out, new


def cross_attend(cfg, lp, x, enc_k, enc_v):
    """Cross attention (whisper decoder).  enc_[kv]: (B,S_enc,KV,hd)."""
    B, Sq, _ = x.shape
    q = torch.einsum("bsd,dq->bsq", x, lp["wq"])
    if "bq" in lp:
        q = q + expand_rank(lp["bq"], q.dim())
    q = q.reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    mask = torch.ones((1, 1, Sq, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _scores_to_out(cfg, q, enc_k, enc_v, mask)
    return torch.einsum("bsq,qd->bsd", out.reshape(B, Sq, -1), lp["wo"])


def project_cross_kv(cfg, lp, enc_out):
    """Precompute cross-attention K/V from encoder output (done once)."""
    B, S, _ = enc_out.shape
    k = torch.einsum("bsd,dk->bsk", enc_out, lp["wk"])
    v = torch.einsum("bsd,dk->bsk", enc_out, lp["wv"])
    if "bk" in lp:
        k = k + expand_rank(lp["bk"], k.dim())
        v = v + expand_rank(lp["bv"], v.dim())
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))
