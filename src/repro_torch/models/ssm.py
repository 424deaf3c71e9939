"""Mamba-2 SSD (state-space duality) mixer.

The port's copy of ``repro.models.ssm``, after [arXiv:2405.21060] §6: the
sequence is split into chunks; intra-chunk interactions are a masked
matmul (dual "attention" form), inter-chunk state is carried across the
chunks in order.  ``apply_ssm`` runs the SSD through its ``ssd_fn`` hook,
by default the kernel's route ``kernels.ssd_scan.ops.ssd_scan`` (the CUDA
kernel on a CUDA tensor, ``ssd_chunked`` on a CPU tensor), which returns
the final state as well, so ``return_state=True`` runs on the kernel too;
``ssd_fn=ssd_chunked`` runs the plain chunked SSD on any device.

Decode is the classic recurrent update h' = h·exp(dtA) + dt·(B ⊗ x).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.devices import resolve_device
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.common import expand_rank, fan_in_init, rms_norm

F32 = torch.float32

__all__ = ["apply_ssm", "causal_depthwise_conv", "decode_ssm", "init_ssm",
           "init_ssm_state", "ssd_chunked", "ssm_dims"]


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    proj_dim = 2 * d_inner + 2 * N + H
    return d_inner, H, N, conv_dim, proj_dim


def init_ssm(cfg, key, dtype, n_layers=None, device=None):
    L = n_layers if n_layers is not None else cfg.n_layers
    d = cfg.d_model
    d_inner, H, N, conv_dim, proj_dim = ssm_dims(cfg)
    ks = prng.split(key, 4)
    dev = resolve_device(device)
    return {
        "in_proj": fan_in_init(ks[0], (L, d, proj_dim), dtype, device=dev),
        "conv_w": fan_in_init(ks[1], (L, conv_dim, cfg.ssm_conv_width),
                              dtype, device=dev),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((L, H), dtype=dtype, device=dev),
        "A_log": torch.zeros((L, H), dtype=dtype, device=dev),  # A = -1 init
        "D": torch.ones((L, H), dtype=dtype, device=dev),
        "gate_norm": torch.ones((L, d_inner), dtype=dtype, device=dev),
        "out_proj": fan_in_init(ks[2], (L, d_inner, d), dtype, device=dev),
    }


def causal_depthwise_conv(x, w, b):
    """x: (B,S,C), w: (C,W), b: (C,).  Causal depthwise conv (cross-
    correlation over the W-1 previous steps and this one), as W shifted
    multiply-adds in f32."""
    S, W = x.shape[1], w.shape[-1]
    xp = F.pad(x.to(F32), (0, 0, W - 1, 0))
    wf = w.to(F32)
    out = xp[:, 0:S] * wf[:, 0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wf[:, k]
    return (out + expand_rank(b.to(F32), out.dim())).to(x.dtype)


def _split_proj(cfg, zxbcdt):
    d_inner, H, N, _, _ = ssm_dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt, d_inner, H, N


def apply_ssm(cfg, lp, x, *, return_state: bool = False, ssd_fn=None):
    """Full-sequence mamba2 mixer.  x: (B,S,d) -> (B,S,d).

    ``ssd_fn(x, dt, A, B, C, chunk) -> (y, final_state)``; None means the
    kernel's route ``kernels.ssd_scan.ops.ssd_scan``.  The chunk is
    ``cfg.ssm_chunk``."""
    B_, S, _ = x.shape
    zxbcdt = torch.einsum("bsd,dk->bsk", x, lp["in_proj"])
    z, xBC, dt, d_inner, H, N = _split_proj(cfg, zxbcdt)

    xBC = F.silu(causal_depthwise_conv(xBC, lp["conv_w"], lp["conv_b"]))
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + N]
    Cm = xBC[..., d_inner + N:]

    dt = F.softplus(dt.to(F32) + expand_rank(lp["dt_bias"].to(F32),
                                             dt.dim()))
    A = -torch.exp(lp["A_log"].to(F32))

    P = cfg.ssm_head_dim
    xh = xs.reshape(B_, S, H, P)
    ssd_fn = ssd_scan if ssd_fn is None else ssd_fn
    y, final = ssd_fn(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + lp["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(B_, S, d_inner)

    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), lp["gate_norm"],
                 cfg.norm_eps)
    out = torch.einsum("bsk,kd->bsd", y, lp["out_proj"])
    if return_state:
        # conv state: last (W-1) xBC inputs (pre-activation path needs raw
        # conv input; we store the raw projection tail)
        raw_xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
        W = cfg.ssm_conv_width
        conv_state = raw_xBC[:, -(W - 1):, :]
        return out, final, conv_state
    return out


def init_ssm_state(cfg, batch: int, n_layers=None, device=None):
    L = n_layers if n_layers is not None else cfg.n_layers
    d_inner, H, N, conv_dim, _ = ssm_dims(cfg)
    P = cfg.ssm_head_dim
    dev = resolve_device(device)
    return {
        "h": torch.zeros((L, batch, H, N, P), dtype=F32, device=dev),
        "conv": torch.zeros((L, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=F32, device=dev),
    }


def decode_ssm(cfg, lp, x, h_state, conv_state):
    """Single-token recurrent step.

    x: (B,1,d); h_state: (B,H,N,P); conv_state: (B,W-1,conv_dim).
    Returns (out (B,1,d), new_h, new_conv).
    """
    B_ = x.shape[0]
    zxbcdt = torch.einsum("bsd,dk->bsk", x, lp["in_proj"])[:, 0]  # (B,k)
    z, xBC, dt, d_inner, H, N = _split_proj(cfg, zxbcdt[:, None, :])
    z, xBC, dt = z[:, 0], xBC[:, 0], dt[:, 0]

    # conv ring: window = [conv_state, xBC]
    win = torch.cat([conv_state.to(xBC.dtype), xBC[:, None, :]],
                    dim=1)                                      # (B,W,conv)
    conv_out = torch.einsum("bwc,cw->bc", win.to(F32),
                            lp["conv_w"].to(F32)) \
        + expand_rank(lp["conv_b"].to(F32), 2)
    xBC_act = F.silu(conv_out)
    new_conv = win[:, 1:, :].to(F32)

    xs = xBC_act[..., :d_inner]
    Bm = xBC_act[..., d_inner:d_inner + N]
    Cm = xBC_act[..., d_inner + N:]

    dt = F.softplus(dt.to(F32) + expand_rank(lp["dt_bias"].to(F32),
                                             dt.dim()))         # (B,H)
    A = -torch.exp(lp["A_log"].to(F32))                         # (H,)
    P = cfg.ssm_head_dim
    xh = xs.reshape(B_, H, P).to(F32)

    decay = torch.exp(dt * expand_rank(A, dt.dim()))            # (B,H)
    new_h = h_state * decay[..., None, None] \
        + torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, new_h) \
        + lp["D"].to(F32)[None, :, None] * xh
    y = y.reshape(B_, d_inner)

    y = rms_norm(y * F.silu(z.to(F32)), lp["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bk,kd->bd", y.to(x.dtype), lp["out_proj"])
    return out[:, None, :], new_h, new_conv
