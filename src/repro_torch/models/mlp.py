"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain GELU MLPs.

The port's copy of ``repro.models.mlp`` (plain torch; cuBLAS on the
card)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.devices import resolve_device
from repro_torch.models.common import expand_rank, fan_in_init, gated_act


def init_mlp(cfg, key, dtype, *, n_layers=None, d_ff=None, device=None):
    L = n_layers if n_layers is not None else cfg.n_layers
    ff = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    ks = prng.split(key, 3)
    if cfg.activation in ("silu", "geglu"):
        p = {
            "wg": fan_in_init(ks[0], (L, d, ff), dtype, device=device),
            "wu": fan_in_init(ks[1], (L, d, ff), dtype, device=device),
            "wd": fan_in_init(ks[2], (L, ff, d), dtype, device=device),
        }
    else:  # plain gelu (whisper / grok expert style handled in moe)
        p = {
            "wu": fan_in_init(ks[0], (L, d, ff), dtype, device=device),
            "wd": fan_in_init(ks[1], (L, ff, d), dtype, device=device),
        }
        if cfg.mlp_bias:
            dev = resolve_device(device)
            p["bu"] = torch.zeros((L, ff), dtype=dtype, device=dev)
            p["bd"] = torch.zeros((L, d), dtype=dtype, device=dev)
    return p


def apply_mlp(cfg, lp, x):
    """lp holds one layer's slices (no leading L axis)."""
    if "wg" in lp:
        gate = torch.einsum("bsd,df->bsf", x, lp["wg"])
        up = torch.einsum("bsd,df->bsf", x, lp["wu"])
        h = gated_act(cfg.activation, gate, up)
    else:
        h = torch.einsum("bsd,df->bsf", x, lp["wu"])
        if "bu" in lp:
            h = h + expand_rank(lp["bu"], h.dim())
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("bsf,fd->bsd", h, lp["wd"])
    if "bd" in lp:
        out = out + expand_rank(lp["bd"], out.dim())
    return out
