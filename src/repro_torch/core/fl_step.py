"""The FL round step for LLM-scale architectures (the port's copy of
``repro.core.fl_step``).

One call is one synchronous round over the client cohorts of ``batch``:
  * each cohort's gradient of ``train_loss`` on its batch (the reference
    vmaps over cohorts with ``spmd_axis_name``; here a loop over them,
    summed in client order);
  * per-client DP: each cohort's update is clipped to C and Gaussian
    noise N(0, C²σ²) added (Algorithm 1 lines 17/23 adapted to
    user-level DP);
  * the server step ``w ← w − η̄ Σ_c U_c``.

The gradient goes through the reference's own training cores (the dense
attention and the chunked SSD: the kernels have no backward); the serve
and prefill steps take the kernels' routes.  One card, no mesh:
``client_axis`` and ``grad_pspecs`` are accepted for the reference's
signature and ignored.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng, tree
from repro_torch.models import model as model_api
from repro_torch.models.attention import dense_attention
from repro_torch.models.ssm import ssd_chunked

F32 = torch.float32


def tree_global_norm(t) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32)))
                          for l in tree.leaves(t)))


def tree_clip(t, clip_norm: float):
    norm = tree_global_norm(t)
    scale = (1.0 / torch.clamp(norm / clip_norm, min=1.0)).to(F32)
    return tree.tree_map(lambda l: (l.to(F32) * scale).to(l.dtype), t)


def tree_add_noise(t, rng, stddev: float):
    """``leaf + stddev * normal(key_i, leaf dtype)``, keys from
    ``split(rng, n_leaves)`` in jax's leaf order; ``rng`` on the CPU.
    f32 leaves (jax draws narrower normals another way)."""
    flat = tree.leaves(t)
    keys = prng.split(rng, len(flat))
    out = []
    for l, k in zip(flat, keys):
        if l.dtype != F32:
            raise TypeError(f"noise is drawn for f32 leaves, got {l.dtype}")
        out.append(l + stddev * prng.normal(k, tuple(l.shape),
                                            device=l.device))
    return tree.unflatten(t, out)


def make_train_step(cfg, run_cfg, *, n_client_shards: int,
                    client_axis: Optional[str] = None, unroll: bool = False,
                    grad_pspecs=None):
    """Build ``train_step(params, momentum, batch, eta_bar, rng)``.

    batch: dict of tensors with leading (C, B_local, ...) axes; ``rng``
    one key on the CPU.  Returns (new_params, new_momentum, metrics).
    """
    dp = run_cfg.fl.dp
    momentum_coef = 0.0  # paper uses plain SGD; momentum available via optim

    def per_client_update(params, client_batch, rng):
        flat = [l.detach().requires_grad_(True) for l in tree.leaves(params)]
        with torch.enable_grad():
            loss = model_api.train_loss(
                cfg, tree.unflatten(params, flat), client_batch,
                remat=run_cfg.remat, unroll=unroll,
                attn_core=dense_attention, ssd_fn=ssd_chunked)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        g = tree.unflatten(params, [torch.zeros_like(p) if d is None else d
                                    for p, d in zip(flat, grads)])
        if dp.enabled:
            g = tree_clip(g, dp.clip_norm)
            g = tree_add_noise(g, rng, dp.clip_norm * dp.sigma)
        return g, loss.detach()

    def train_step(params, momentum, batch, eta_bar, rng):
        rngs = prng.split(rng, n_client_shards)
        if n_client_shards > 1:
            U, losses = None, []
            for c in range(n_client_shards):
                g, loss = per_client_update(
                    params, {k: v[c] for k, v in batch.items()}, rngs[c])
                U = g if U is None else tree.tree_map(torch.add, U, g)
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:
            U, loss = per_client_update(
                params, {k: v[0] for k, v in batch.items()}, rngs[0])

        if momentum is not None:
            momentum = tree.tree_map(
                lambda m, u: momentum_coef * m + u.to(m.dtype), momentum, U)
            upd = momentum
        else:
            upd = U
        e = float(eta_bar)
        new_params = tree.tree_map(
            lambda p, u: (p.to(F32) - e * u.to(F32)).to(p.dtype),
            params, upd)
        metrics = {"loss": loss.to(F32), "update_norm": tree_global_norm(U)}
        return new_params, momentum, metrics

    return train_step


def make_serve_step(cfg, run_cfg, *, seq_len: int, unroll: bool = False):
    def serve_step(params, cache, tokens, pos):
        return model_api.serve_step(cfg, params, cache, tokens, pos,
                                    seq_len=seq_len, unroll=unroll)
    return serve_step


def make_prefill_step(cfg, run_cfg, *, unroll: bool = False):
    def prefill_step(params, batch):
        return model_api.forward_prefill(cfg, params, batch,
                                         remat=run_cfg.remat, unroll=unroll)
    return prefill_step
