"""Mixture-of-Experts layer: top-k routing, group-limited one-hot dispatch.

The port's copy of ``repro.models.moe``: tokens are split into groups
of ``group_size`` (batch, seq-block); within each group, capacity is
C_g = group_size*top_k*factor/E, and tokens over capacity are dropped
(GShard semantics; the residual carries them).  A Switch-style
load-balance auxiliary loss regularizes the router.  Routing is integer
work, so it follows the reference's tie rules exactly: ``top_k`` takes
the lower expert index first among equal probabilities (a stable sort),
and a one-hot of an index past its width is all zeros, as ``jax.nn.
one_hot`` gives it.  The reference's expert-sharding hooks
(``constrain``, ``constrain_expert``) sit where the reference calls
them; they act only on DTensors under a spec the dry run installs, and
are the identity otherwise.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.models.common import fan_in_init, gated_act
from repro_torch.sharding.context import constrain, constrain_expert

F32 = torch.float32


def init_moe(cfg, key, dtype, device=None):
    L, d, E, ff = cfg.n_layers, cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    ks = prng.split(key, 5)
    gated = cfg.activation in ("silu", "geglu")
    p = {"router": fan_in_init(ks[0], (L, d, E), dtype, device=device)}
    if gated:
        p["wg"] = fan_in_init(ks[1], (L, E, d, ff), dtype, device=device)
    p["wu"] = fan_in_init(ks[2], (L, E, d, ff), dtype, device=device)
    p["wd"] = fan_in_init(ks[3], (L, E, ff, d), dtype, device=device)
    if cfg.n_shared_experts:
        sf = cfg.n_shared_experts * ff
        p["shared_wg"] = fan_in_init(ks[4], (L, d, sf), dtype, device=device)
        p["shared_wu"] = fan_in_init(prng.fold_in(ks[4], 1), (L, d, sf),
                                     dtype, device=device)
        p["shared_wd"] = fan_in_init(prng.fold_in(ks[4], 2), (L, sf, d),
                                     dtype, device=device)
    return p


def group_capacity(group_size: int, n_experts: int, top_k: int,
                   factor: float = 1.25) -> int:
    c = int(group_size * top_k * factor / n_experts)
    return max(4, -(-c // 4) * 4)


MOE_COMBINE_DTYPE = (torch.bfloat16
                     if os.environ.get("REPRO_MOE_BF16_COMBINE") == "1"
                     else F32)


def _one_hot(idx, n: int):
    """f32 one-hot over the last axis; an index outside [0, n) gives all
    zeros (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(cfg, lp, x, *, capacity_factor: float = None,
              group_size: int = 256):
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar f32).

    ``capacity_factor`` None reads ``REPRO_MOE_CAPACITY`` at call time
    (default 1.25), as the reference does."""
    if capacity_factor is None:
        capacity_factor = float(os.environ.get("REPRO_MOE_CAPACITY",
                                               "1.25"))
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    gs = min(group_size, S)
    pad = (-S) % gs
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    Sp = S + pad
    M = Sp // gs
    xg = xp.reshape(B, M, gs, d)
    valid = (torch.arange(Sp, device=x.device) < S).expand(B, Sp).reshape(
        B, M, gs)

    logits = torch.einsum("bmnd,de->bmne", xg.to(F32), lp["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)                  # (B,M,gs,E)
    top_w, top_i = top_k(probs, K)                         # (B,M,gs,K)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    Cg = group_capacity(gs, E, K, capacity_factor)

    counts = torch.zeros((B, M, E), dtype=F32, device=x.device)
    dispatch = constrain(torch.zeros((B, M, gs, E, Cg), dtype=x.dtype,
                                     device=x.device))
    combine = constrain(torch.zeros((B, M, gs, E, Cg),
                                    dtype=MOE_COMBINE_DTYPE,
                                    device=x.device))
    for k in range(K):                                      # K <= 4
        oh = _one_hot(top_i[..., k], E) * valid[..., None]  # (B,M,gs,E)
        pos = torch.cumsum(oh, dim=2) - oh + counts[:, :, None, :]
        pos_tok = torch.sum(pos * oh, dim=-1)               # (B,M,gs)
        keep = (pos_tok < Cg) & (torch.sum(oh, dim=-1) > 0)
        ohk = oh * keep[..., None]
        counts = counts + torch.sum(ohk, dim=2)
        slot_oh = _one_hot(pos_tok.to(torch.int64), Cg) * keep[..., None]
        disp_k = ohk[..., None] * slot_oh[..., None, :]     # (B,M,gs,E,Cg)
        dispatch = dispatch + disp_k.to(x.dtype)
        combine = combine + (disp_k * top_w[..., k, None, None]
                             ).to(MOE_COMBINE_DTYPE)

    # Switch load-balance loss over valid tokens
    nv = torch.clamp(torch.sum(valid.to(F32)), min=1.0)
    f_e = torch.sum(counts, dim=(0, 1)) / (nv * K / E)
    P_e = torch.sum(probs * valid[..., None], dim=(0, 1, 2)) / nv
    aux = torch.sum(f_e * P_e)

    xe = constrain_expert(torch.einsum("bmnec,bmnd->bmecd", dispatch, xg),
                          last_is_ff=False)
    if "wg" in lp:
        gate = constrain_expert(
            torch.einsum("bmecd,edf->bmecf", xe, lp["wg"]), last_is_ff=True)
        up = constrain_expert(
            torch.einsum("bmecd,edf->bmecf", xe, lp["wu"]), last_is_ff=True)
        act = gated_act(cfg.activation, gate, up)
    else:
        act = constrain_expert(F.gelu(
            torch.einsum("bmecd,edf->bmecf", xe, lp["wu"]),
            approximate="tanh"), last_is_ff=True)
    ye = constrain_expert(torch.einsum("bmecf,efd->bmecd", act, lp["wd"]),
                          last_is_ff=False)
    out = torch.einsum("bmnec,bmecd->bmnd", combine.to(x.dtype), ye)
    out = out.reshape(B, Sp, d)[:, :S]

    if "shared_wg" in lp:
        gate = torch.einsum("bsd,df->bsf", x, lp["shared_wg"])
        up = torch.einsum("bsd,df->bsf", x, lp["shared_wu"])
        out = out + torch.einsum("bsf,fd->bsd",
                                 gated_act("silu", gate, up),
                                 lp["shared_wd"])

    return out, aux
