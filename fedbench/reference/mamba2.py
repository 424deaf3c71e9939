"""Mamba-2 (arXiv:2405.21060), plainly: a decoder of SSD mixers, its
next-token loss and a client's local minibatch steps.

Layer: ``x + mixer(rmsnorm(x))``.  Mixer: ``[z | xBC | dt] = h W_in``; a
causal depthwise convolution of width W over ``xBC`` and SiLU; ``xBC``
split into ``x`` (heads of P), ``B`` and ``C`` (one group of N);
``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD
``y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r A) dt_s x_s + D x_t``
by chunks (``ssd``); ``rmsnorm(y * silu(z))``
and ``W_out``.  Tied embeddings: the logits are ``h E^T`` over the
published vocabulary (rows past it are storage padding).

The parameters are one flat f32 vector, its leaves in the order of their
names sorted at every level (``blocks.ln1.scale``, ``blocks.ssm.A_log``,
... , ``embed``, ``final_norm.scale``), each stacked over the layers.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench.reference import threefry


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg["ssm_expand"] * d
    H = di // cfg["ssm_head_dim"]
    N = cfg["ssm_state"]
    V = cfg["vocab_size"]
    return dict(d=d, di=di, H=H, N=N, P=cfg["ssm_head_dim"],
                W=cfg["ssm_conv_width"], L=cfg["n_layers"], V=V,
                Vp=V + (-V) % 256 if V % 256 and V >= 256 else V,
                conv=di + 2 * N, proj=2 * di + 2 * N + H)


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf, in the flat vector's order."""
    m = dims(cfg)
    L, d, di, H = m["L"], m["d"], m["di"], m["H"]
    return [("blocks.ln1.scale", (L, d)),
            ("blocks.ssm.A_log", (L, H)),
            ("blocks.ssm.D", (L, H)),
            ("blocks.ssm.conv_b", (L, m["conv"])),
            ("blocks.ssm.conv_w", (L, m["conv"], m["W"])),
            ("blocks.ssm.dt_bias", (L, H)),
            ("blocks.ssm.gate_norm", (L, di)),
            ("blocks.ssm.in_proj", (L, d, m["proj"])),
            ("blocks.ssm.out_proj", (L, di, d)),
            ("embed", (m["Vp"], d)),
            ("final_norm.scale", (d,))]


def spans(cfg: dict) -> List[Tuple[str, int, int]]:
    """(name, offset, size) of every leaf in the flat vector."""
    out, o = [], 0
    for name, shape in layout(cfg):
        n = int(np.prod(shape))
        out.append((name, o, n))
        o += n
    return out


def unflat(cfg: dict, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The leaves of ``vec`` by name, as views."""
    return {name: vec[o:o + n].view(shape) for (name, shape), (_, o, n)
            in zip(layout(cfg), spans(cfg))}


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def ssd(x, dt, A, Bm, Cm, Q: int) -> torch.Tensor:
    """``y_t = sum_{s<=t} (C_t . B_s) exp(sum_{s<r<=t} dt_r A) dt_s x_s``
    for x (b, S, h, p), dt (b, S, h), A (h), B and C (b, S, n), by
    chunks of Q steps: within a chunk in the quadratic form, across
    chunks through each chunk's end state."""
    b, S, H, P = x.shape
    pad = (-S) % Q
    if pad:         # dt = 0 and x = 0: the padded steps add nothing
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    nc = (S + pad) // Q
    x = x.reshape(b, nc, Q, H, P)
    dt = dt.reshape(b, nc, Q, H)
    Bm = Bm.reshape(b, nc, Q, -1)
    Cm = Cm.reshape(b, nc, Q, -1)
    cum = torch.cumsum(dt * A, dim=2)                   # (b, c, Q, h)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, c, t, s, h)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal[:, :, None], seg, float("-inf")))
    scores = torch.einsum("bctn,bcsn->bcts", Cm, Bm)
    wts = scores[..., None] * decay * dt[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", wts, x)
    # each chunk's own end state, then the states carried chunk to chunk
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dt      # (b, c, Q, h)
    own = torch.einsum("bcsh,bcsn,bcshp->bchnp", w_end, Bm, x)
    state = torch.zeros_like(own[:, 0])
    before = []
    for c in range(nc):
        before.append(state)
        state = state * torch.exp(cum[:, c, -1])[..., None, None] + own[:, c]
    before = torch.stack(before, dim=1)                 # (b, c, h, n, p)
    y = y + torch.einsum("bctn,bcth,bchnp->bcthp", Cm, torch.exp(cum),
                         before)
    return y.reshape(b, nc * Q, H, P)[:, :S]


def mixer(cfg: dict, p, l: int, h: torch.Tensor) -> torch.Tensor:
    m = dims(cfg)
    di, H, N, P, W = m["di"], m["H"], m["N"], m["P"], m["W"]
    Bsz, S, _ = h.shape
    zxbcdt = h @ p["blocks.ssm.in_proj"][l]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    w = p["blocks.ssm.conv_w"][l]                       # (conv, W)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = sum(xp[:, k:k + S] * w[:, k] for k in range(W))
    xbc = F.silu(conv + p["blocks.ssm.conv_b"][l])
    x = xbc[..., :di].reshape(Bsz, S, H, P)
    Bm = xbc[..., di:di + N]
    Cm = xbc[..., di + N:]
    dt = F.softplus(dt + p["blocks.ssm.dt_bias"][l])   # (B, S, H)
    A = -torch.exp(p["blocks.ssm.A_log"][l])
    y = ssd(x, dt, A, Bm, Cm, cfg["ssm_chunk"])
    y = y + p["blocks.ssm.D"][l][None, None, :, None] * x
    y = _rms(y.reshape(Bsz, S, di) * F.silu(z),
             p["blocks.ssm.gate_norm"][l], cfg["norm_eps"])
    return y @ p["blocks.ssm.out_proj"][l]


def loss(cfg: dict, p, tokens: torch.Tensor,
         rows: slice = slice(None)) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` (B, S + 1) over the
    batch rows ``rows``."""
    m = dims(cfg)
    eps = cfg["norm_eps"]
    tokens = tokens[rows]
    x = p["embed"][tokens[:, :-1]]

    def layer(x, l):
        return x + mixer(cfg, p, l, _rms(x, p["blocks.ln1.scale"][l], eps))
    for l in range(m["L"]):
        # each layer run again in backward: one layer's activations held
        x = checkpoint(layer, x, l, use_reentrant=False)
    h = _rms(x, p["final_norm.scale"], eps)
    logits = h @ p["embed"][:m["V"]].T
    return F.cross_entropy(logits.reshape(-1, m["V"]),
                           tokens[:, 1:].reshape(-1))


def step_flops(cfg: dict, B: int, S: int) -> float:
    """Model flops of one minibatch step, forward and backward: 6 a
    weight a token for the projections, the convolution and the tied
    head over the published vocabulary, and 3 times the SSD's forward
    products a layer, counted from its chunked form (chunks of Q
    tokens): within a chunk, the causal pairs' scores C B^T (2N a pair),
    their decay weights (2H) and weighted sums of x (2HP); across
    chunks, each token's share of its chunk's state and its read of the
    state before it (2NHP each), and each chunk's state carried on
    (2NHP)."""
    m = dims(cfg)
    T = B * S
    per_layer = (m["d"] * m["proj"] + m["di"] * m["d"] + m["conv"] * m["W"])
    weights = m["L"] * per_layer + m["V"] * m["d"]
    Q = cfg["ssm_chunk"]
    lens = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    pairs = B * sum(q * (q + 1) / 2 for q in lens)
    state = m["N"] * m["H"] * m["P"]
    core = m["L"] * (pairs * (2 * m["N"] + 2 * m["H"] * m["P"] + 2 * m["H"])
                     + T * 4 * state + B * len(lens) * 2 * state)
    return 6.0 * weights * T + 3.0 * core


class LocalSteps:
    """``block_fn`` of ``PlainCohort``: each client's minibatch steps,
    the batch of step ``h`` of round ``i`` at client ``c`` made by
    ``batch(fold_in(fold_in(fold_in(base, c), i), h))``; the gradient
    clipped to global norm ``clip``; ``U += g``, ``w -= eta g``.  Losses
    are kept by the step's address (client, round, offset)."""

    def __init__(self, cfg: dict, batch, *, C: int, base, clip: float,
                 rows: slice = slice(None), tf32: bool = False):
        self.cfg, self.batch, self.clip = cfg, batch, float(clip)
        self.base = [threefry.fold_in(base, c) for c in range(C)]
        self.rows, self.tf32 = rows, tf32
        self.losses: Dict[Tuple[int, int, int], float] = {}

    def __call__(self, w, U, i, h, n, eta):
        mm = torch.backends.cuda.matmul
        was = mm.allow_tf32
        mm.allow_tf32 = self.tf32
        try:
            self._steps(w, U, i, h, n, eta)
        finally:
            mm.allow_tf32 = was

    def _steps(self, w, U, i, h, n, eta):
        for c in np.flatnonzero(n > 0):
            rk = threefry.fold_in(self.base[c], int(i[c]))
            for j in range(int(n[c])):
                k0, k1 = threefry.fold_in(rk, int(h[c]) + j)
                tokens = self.batch(torch.tensor(k0, device=w.device),
                                    torch.tensor(k1, device=w.device))
                leaves = [t.detach().requires_grad_(True) for t in
                          unflat(self.cfg, w[c]).values()]
                p = dict(zip(unflat(self.cfg, w[c]).keys(), leaves))
                with torch.enable_grad():
                    l = loss(self.cfg, p, tokens, self.rows)
                    g = torch.autograd.grad(l, leaves)
                self.losses[(int(c), int(i[c]), int(h[c]) + j)] = float(
                    l.detach())
                norm = torch.sqrt(sum((x * x).sum() for x in g))
                s = 1.0 / torch.clamp(norm / self.clip, min=1.0)
                with torch.no_grad():
                    flat = torch.cat([x.reshape(-1) for x in g]) * s
                    U[c] += flat
                    w[c] -= eta[c] * flat
                del g, flat, leaves, p
