"""Shared neural-net building blocks (plain PyTorch, no ``nn.Module``).

The port's copy of ``repro.models.common``.  Parameters are plain nested
dicts of tensors; per-layer parameters are *stacked* on a leading layer
axis as in the reference (``convert.layer`` takes one layer's slice).
Every f32 upcast is where the reference writes it.  Initializers draw
from ``repro_torch.prng`` (jax's threefry bits; normals within a few
ulp) on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.devices import resolve_device

F32 = torch.float32


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(key, shape, dtype, stddev: float = 0.02, device=None):
    dev = resolve_device(device)
    if dev.type == "meta":          # shapes only: nothing to draw
        return torch.empty(shape, dtype=dtype, device=dev)
    return (stddev * prng.normal(key, shape, device=dev)).to(dtype)


def fan_in_init(key, shape, dtype, device=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(key, shape, dtype, stddev=1.0 / math.sqrt(fan_in),
                       device=device)


def zeros_init(_key, shape, dtype, device=None):
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def ones_init(_key, shape, dtype, device=None):
    return torch.ones(shape, dtype=dtype, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def expand_rank(v, ndim: int):
    """Left-pad ``v`` with unit axes so it broadcasts against a rank-``ndim``
    tensor along trailing axes (the reference's explicit broadcast)."""
    return v.reshape((1,) * (ndim - v.dim()) + tuple(v.shape))


def rms_norm(x, scale, eps: float = 1e-6, *, gemma_style: bool = False):
    """RMSNorm.  gemma_style uses (1 + scale) weighting."""
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.to(F32)) if gemma_style else scale.to(F32)
    return (x * expand_rank(w, x.dim())).to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dtype = x.dtype
    x = x.to(F32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * expand_rank(scale.to(F32), x.dim())
            + expand_rank(bias.to(F32), x.dim())).to(dtype)


def apply_norm(cfg, x, params):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps,
                    gemma_style=cfg.embed_scale)


def init_norm(cfg, key, d, dtype, device=None):
    if cfg.norm == "layernorm":
        dev = resolve_device(device)
        return {"scale": torch.ones((d,), dtype=dtype, device=dev),
                "bias": torch.zeros((d,), dtype=dtype, device=dev)}
    init = zeros_init if cfg.embed_scale else ones_init
    return {"scale": init(key, (d,), dtype, device=device)}


# ---------------------------------------------------------------------------
# Activations / softcap
# ---------------------------------------------------------------------------

def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def gated_act(kind: str, gate, up):
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if kind == "silu":
        return F.silu(gate) * up
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=F32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, head_dim); positions: (..., S)."""
    if theta <= 0:
        return x
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    pos = positions[..., None].to(F32)                         # (..., S, 1)
    angles = pos * expand_rank(freqs, pos.dim())               # (..., S, hd/2)
    angles = angles[..., None, :]                              # (..., S, 1, hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, device=None):
    """Whisper-style fixed sinusoidal position embeddings."""
    pos = torch.arange(seq_len, dtype=F32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=F32, device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / d_model)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (S, d_model)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    """Storage rows of the embedding table: odd vocabularies are padded
    to a multiple of 256 (ids never reach the pad rows, pad logits are
    masked out of the softmax), as the reference stores them."""
    if vocab_size % multiple == 0 or vocab_size < multiple:
        return vocab_size
    return vocab_size + (-vocab_size) % multiple


def embed_tokens(cfg, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # the reference rounds sqrt(d) to x's dtype before the product
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(cfg, params, x):
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("...d,vd->...v", x, table)
    logits = softcap(logits.to(F32), cfg.logit_softcap)
    Vp = table.shape[0]
    if Vp != cfg.vocab_size:   # mask padded rows out of the softmax
        valid = torch.arange(Vp, device=x.device) < cfg.vocab_size
        logits = torch.where(expand_rank(valid, logits.dim()), logits, -1e30)
    return logits


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token-level cross entropy.  logits f32 (..., V), labels int."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.to(F32)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
