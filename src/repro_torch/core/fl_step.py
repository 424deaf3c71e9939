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
and prefill steps take the kernels' routes.

On plain tensors (one card) ``client_axis`` and ``grad_pspecs`` change
nothing.  On DTensors (the dry run's meshes) ``grad_pspecs`` pins each
client's gradient to the parameters' placements, and ``client_axis``
(the reference's ``spmd_axis_name``) runs client ``c``'s update on pod
``c``'s ("data", "model") sub-mesh — each rank computes its own pod's
client — and sums U over the pods (the cross-pod all-reduce).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng, tree
from repro_torch.models import model as model_api
from repro_torch.models.attention import dense_attention
from repro_torch.models.ssm import ssd_chunked
from repro_torch.sharding.context import constrain_tree, contiguous_stride

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

    batch: dict of tensors with leading (C, B_local, ...) axes;
    ``eta_bar`` a host scalar (a 0-d CPU tensor is read with ``float``);
    ``rng`` one key on the CPU.  Returns (new_params, new_momentum, metrics).
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
        if grad_pspecs is not None:
            g = constrain_tree(g, grad_pspecs)
        if dp.enabled:
            g = tree_clip(g, dp.clip_norm)
            g = tree_add_noise(g, rng, dp.clip_norm * dp.sigma)
        return g, loss.detach()

    def train_step(params, momentum, batch, eta_bar: float, rng):
        rngs = prng.split(rng, n_client_shards)
        pods = _ClientPods.of(params, client_axis)
        if n_client_shards > 1 and pods is not None:
            c = pods.client
            g, loss = per_client_update(
                pods.params(params),
                {k: pods.client_slice(v) for k, v in batch.items()},
                rngs[c])
            U = pods.sum_over_pods(g)
            loss = pods.sum_over_pods(loss) / n_client_shards
        elif n_client_shards > 1:
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


class _ClientPods:
    """The client axis of a DTensor mesh: this rank's pod (its client),
    the pod's sub-mesh over the other axes, and the moves between the
    two meshes (the counterpart of the reference's ``vmap`` with
    ``spmd_axis_name``)."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names)
        self.mesh, self.ax = mesh, names.index(axis)
        self.sub = mesh[tuple(n for n in names if n != axis)]
        self.client = mesh.get_local_rank(axis)

    @classmethod
    def of(cls, params, axis):
        from torch.distributed.tensor import DTensor
        leaf = tree.leaves(params)[0]
        if axis is None or not isinstance(leaf, DTensor) \
                or axis not in leaf.device_mesh.mesh_dim_names:
            return None
        return cls(leaf.device_mesh, axis)

    def _sub_placements(self, x, drop_dim: bool):
        from torch.distributed.tensor import Shard
        pls = [p for i, p in enumerate(x.placements) if i != self.ax]
        if drop_dim:
            pls = [Shard(p.dim - 1) if p.is_shard() else p for p in pls]
        return pls

    def params(self, params):
        """Each leaf (replicated over the pods) on the sub-mesh."""
        from torch.distributed.tensor import DTensor
        return tree.tree_map(
            lambda x: DTensor.from_local(
                x.to_local(), self.sub, self._sub_placements(x, False),
                shape=x.shape, stride=x.stride(), run_check=False),
            params)

    def client_slice(self, x):
        """This pod's client of a (C, ...) batch leaf sharded over the
        pods on dim 0, on the sub-mesh."""
        from torch.distributed.tensor import DTensor
        shape = tuple(x.shape[1:])
        return DTensor.from_local(
            x.to_local()[0], self.sub, self._sub_placements(x, True),
            shape=shape, stride=contiguous_stride(shape), run_check=False)

    def sum_over_pods(self, t):
        """Σ over the pods of a sub-mesh tree: partial sums on the full
        mesh, reduced (all-reduce over the client axis)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate

        def one(x):
            pls = list(x.placements)
            part = DTensor.from_local(
                x.to_local(), self.mesh,
                pls[:self.ax] + [Partial("sum")] + pls[self.ax:],
                shape=x.shape, stride=x.stride(), run_check=False)
            return part.redistribute(
                self.mesh, pls[:self.ax] + [Replicate()] + pls[self.ax:])
        return tree.tree_map(one, t)


def make_serve_step(cfg, run_cfg, *, seq_len: int, unroll: bool = False):
    def serve_step(params, cache, tokens, pos: int):
        return model_api.serve_step(cfg, params, cache, tokens, pos,
                                    seq_len=seq_len, unroll=unroll)
    return serve_step


def make_prefill_step(cfg, run_cfg, *, unroll: bool = False):
    def prefill_step(params, batch):
        return model_api.forward_prefill(cfg, params, batch,
                                         remat=run_cfg.remat, unroll=unroll)
    return prefill_step
