"""Task abstraction: the computation a client performs inside a round.

``LogRegTask`` reproduces the paper's experiments: per-iteration
single-sample SGD (Algorithm 1 lines 15-21), optional per-sample gradient
clipping (line 17) and round Gaussian noise (lines 23-24).  The port
keeps its ``sample_seed`` mode, in which the sample drawn at (client,
round, iteration) is a pure function of that address, so trajectories
are reproducible across engines and against the JAX reference.

``BatchModelTask`` adapts any ``repro_torch.models`` architecture: one
"local iteration" is one minibatch-SGD step (the paper's footnote ‡
licenses batch SGD per round); DP clips each step's gradient and adds
round noise to the client's update (user-level DP).

The event simulator runs one client at a time through
``run_iterations`` / ``add_round_noise`` on params trees of tensors on
the engine's device: the reference's jitted power-of-two chunks of
``lax.scan`` become a loop of torch ops per step, with the chunks kept
where they address the sample draws (one key split per chunk without
``sample_seed``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.models import logreg, train_loss
from repro_torch.models.attention import dense_attention
from repro_torch.models.ssm import ssd_chunked

F32 = torch.float32


def global_norm(t) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf of a params tree, in
    f32, leaves summed in jax's order (``repro_torch.tree``) from 0 as
    Python's ``sum`` starts."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(F32)))
                          for l in tree.leaves(t)))


def _promoted(l: torch.Tensor) -> torch.Tensor:
    """``l`` in the dtype jax gives it in an op with an f32 array: f32
    for the narrower floats, unchanged otherwise."""
    return l.to(torch.promote_types(l.dtype, F32))


def clip_tree(t, clip: float):
    """Scale a tree to global norm <= ``clip``: every leaf times
    ``1 / max(1, norm / clip)``, an f32 scalar (so narrower leaves come
    out in f32, as in the reference)."""
    scale = 1.0 / torch.clamp(global_norm(t) / clip, min=1.0)
    return tree.tree_map(lambda l: _promoted(l) * scale, t)


def validate_dp_knobs(dp_clip: float, dp_sigma: float, who: str) -> None:
    """Round noise is drawn with std dp_clip * dp_sigma (Algorithm 1
    line 23 scales the Gaussian by the clip bound), so dp_sigma > 0 with
    dp_clip == 0 would add zero noise while appearing to be private."""
    if dp_sigma > 0.0 and dp_clip <= 0.0:
        raise ValueError(
            f"{who}: dp_sigma={dp_sigma} > 0 requires dp_clip > 0 — the "
            "round-noise std is dp_clip * dp_sigma, so dp_clip == 0 "
            "would add zero noise while appearing to be private")


class LogRegTask:
    """Paper experiment task (strongly-convex / plain-convex logreg).

    Holds the dataset on the CPU; engines copy it to their device
    (``on``).  ``sample_seed``: the sample index of iteration ``h`` of
    round ``i`` at client ``c`` is the first word of
    ``fold_in(fold_in(fold_in(PRNGKey(sample_seed), c), i), h)`` mod n.
    """

    def __init__(self, X, y, *, l2: float = 0.0, dp_clip: float = 0.0,
                 dp_sigma: float = 0.0, d_features: Optional[int] = None,
                 sample_seed: Optional[int] = None):
        self.X = torch.as_tensor(np.asarray(X, np.float32))
        self.y = torch.as_tensor(np.asarray(y, np.float32))
        self.l2 = float(l2)
        self.dp_clip = float(dp_clip)
        self.dp_sigma = float(dp_sigma)
        validate_dp_knobs(self.dp_clip, self.dp_sigma, "LogRegTask")
        self.d = d_features or self.X.shape[1]
        self.sample_seed = sample_seed
        self._on: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(X, y)`` on ``device``, copied once."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = (self.X.to(device), self.y.to(device))
        return self._on[key]

    def init_model(self, key=None, device=None):
        return logreg.init_params(self.d, key, device=device)

    def zero_update(self, device=None) -> Dict[str, torch.Tensor]:
        return {"w": torch.zeros((self.d,), dtype=torch.float32,
                                 device=device),
                "b": torch.zeros((), dtype=torch.float32, device=device)}

    @staticmethod
    def _chunks(n: int):
        """n as descending power-of-two chunks (the reference's jitted
        chunk lengths; without ``sample_seed`` each chunk splits the
        client's key once, so the chunks address the draws)."""
        out, p = [], 1 << 14
        while n > 0 and p > 0:
            while p <= n:
                out.append(p)
                n -= p
            p >>= 1
        return out

    def iteration_key_base(self, client_id: int, round_idx: int):
        """(client, round)-addressed key base for deterministic sampling."""
        return prng.fold_in(prng.fold_in(prng.PRNGKey(self.sample_seed),
                                         int(client_id)), int(round_idx))

    def sample_indices(self, base, h: int, n: int) -> torch.Tensor:
        """Indices of iterations h .. h+n-1: the first word of
        ``fold_in(base, h + j)`` mod n_data (int64, on the key's device)."""
        keys = prng.fold_in(base[None, :],
                            h + torch.arange(n, dtype=torch.int64))
        return keys[:, 0] % self.X.shape[0]

    def run_iterations(self, w, U, *, round_idx, client_id, start_h,
                       n_iters, eta, rng):
        """``n_iters`` single-sample SGD steps of one client from offset
        ``start_h`` of round ``round_idx``: U += g, w -= eta * g, with
        per-sample clipping when ``dp_clip > 0``.  ``rng`` is the
        client's key (on the CPU), used only without ``sample_seed``."""
        dev = w["w"].device
        X, y = self.on(dev)
        h, parts = int(start_h), []
        for c in self._chunks(int(n_iters)):
            if self.sample_seed is not None:
                base = self.iteration_key_base(client_id, round_idx)
                parts.append(self.sample_indices(base, h, c))
            else:
                rng, sub = prng.split(rng)
                parts.append(prng.randint(prng.split(sub, c), (), 0,
                                          X.shape[0]))
            h += c
        if not parts:
            return w, U
        idx = torch.cat(parts).to(dev)
        xs, ys = X[idx], y[idx]
        pw, pb, uw, ub = w["w"], w["b"], U["w"], U["b"]
        for j in range(idx.shape[0]):
            gw, gb = logreg.per_example_grad(pw, pb, xs[j], ys[j], self.l2)
            if self.dp_clip > 0.0:
                g = clip_tree({"w": gw, "b": gb}, self.dp_clip)
                gw, gb = g["w"], g["b"]
            uw = uw + gw
            ub = ub + gb
            pw = pw - eta * gw
            pb = pb - eta * gb
        return {"w": pw, "b": pb}, {"w": uw, "b": ub}

    def add_round_noise(self, w, U, *, eta, rng):
        """Algorithm 1 lines 23-24: U += n, w += eta * n with n ~
        N(0, (dp_clip * dp_sigma)^2) per coordinate, one key per leaf in
        jax's leaf order (``b``, then ``w``).  The client pre-adds eta * n
        so that a later replacement w = v - eta * U stays consistent with
        the noise the server absorbs."""
        if self.dp_sigma <= 0.0:
            return w, U
        dev = w["w"].device
        kb, kw = prng.split(rng, 2)
        scale = self.dp_clip * self.dp_sigma
        nb = scale * prng.normal(kb, (), device=dev)
        nw = scale * prng.normal(kw, (self.d,), device=dev)
        return ({"w": w["w"] + eta * nw, "b": w["b"] + eta * nb},
                {"w": U["w"] + nw, "b": U["b"] + nb})

    def metrics(self, params) -> Dict[str, float]:
        X, y = self.on(params["w"].device)
        return {"loss": float(logreg.batch_loss(params, X, y, self.l2)),
                "accuracy": float(logreg.accuracy(params, X, y))}


class BatchModelTask:
    """LLM-scale task: one local iteration = one minibatch-SGD step.

    ``params_template`` is a params tree of the model API
    (``repro_torch.models.init_params``); the task's tensors live on its
    device.  ``data_fn(client_id, round_idx, h, rng) -> batch``.

    The gradient step differentiates ``train_loss`` through
    ``attn_core`` / ``ssd_fn``, by default the reference's own cores of
    its training step (the q-chunked dense attention and the chunked
    SSD, which jax differentiates there): the ``flash_attention`` and
    ``ssd_scan`` kernels have no backward, in the reference as here.
    ``metrics`` evaluates under ``torch.no_grad()`` through the default
    route, the kernels on a CUDA tensor.  ``remat`` (default True, as
    the reference's) goes to ``train_loss``: each layer body is
    checkpointed and runs again in backward, so a step keeps one layer's
    activations at a time; the loss and gradient are bit for bit those
    of ``remat=False``.  The flat-params cohort adapter steps through
    ``loss_and_grad``, so it carries ``remat`` too.
    """

    def __init__(self, cfg, params_template, data_fn, *,
                 dp_clip: float = 0.0, dp_sigma: float = 0.0,
                 remat: bool = True, attn_core: Callable = dense_attention,
                 ssd_fn: Callable = ssd_chunked):
        self.cfg = cfg
        self.data_fn = data_fn
        self.dp_clip = float(dp_clip)
        self.dp_sigma = float(dp_sigma)
        validate_dp_knobs(self.dp_clip, self.dp_sigma, "BatchModelTask")
        self.template = params_template
        self.remat = bool(remat)
        self.attn_core = attn_core
        self.ssd_fn = ssd_fn
        self._eval_batch = None
        self.last_loss: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return tree.leaves(self.template)[0].device

    def init_model(self, key=None, device=None):
        """The params template (on ``device`` when given)."""
        if device is None:
            return self.template
        return tree.tree_map(lambda l: l.to(device), self.template)

    def zero_update(self, device=None):
        dev = self.device if device is None else device
        return tree.tree_map(
            lambda l: torch.zeros(tuple(l.shape), dtype=F32, device=dev),
            self.template)

    def _batch_on(self, batch, device):
        return {k: v.to(device) for k, v in batch.items()}

    def loss_and_grad(self, params, batch) -> Tuple[torch.Tensor, List]:
        """``train_loss`` of ``params`` on ``batch`` and its gradient, one
        tensor per leaf in ``tree.leaves`` order (zeros for a leaf the
        loss does not reach, as jax's grad gives)."""
        flat = [l.detach().requires_grad_(True) for l in tree.leaves(params)]
        with torch.enable_grad():
            loss = train_loss(self.cfg, tree.unflatten(params, flat), batch,
                              remat=self.remat, attn_core=self.attn_core,
                              ssd_fn=self.ssd_fn)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def _step(self, w, U, batch, eta: float):
        """One minibatch step: U += g, w -= eta * g, with g clipped when
        ``dp_clip > 0``.  ``eta`` is an f32 scalar as in the reference's
        jitted step, so narrower leaves of ``w`` come out in f32."""
        loss, g = self.loss_and_grad(w, batch)
        g = tree.unflatten(w, g)
        if self.dp_clip > 0.0:
            g = clip_tree(g, self.dp_clip)
        e = float(np.float32(eta))
        U = tree.tree_map(lambda u, gg: u + gg, U, g)
        w = tree.tree_map(lambda p, gg: _promoted(p) - e * _promoted(gg),
                          w, g)
        return w, U, loss

    def run_iterations(self, w, U, *, round_idx, client_id, start_h,
                       n_iters, eta, rng):
        dev = tree.leaves(w)[0].device
        for h in range(int(n_iters)):
            rng, sub = prng.split(rng)
            batch = self._batch_on(
                self.data_fn(client_id, round_idx, int(start_h) + h, sub),
                dev)
            w, U, loss = self._step(w, U, batch, eta)
            self.last_loss = float(loss)
        return w, U

    def add_round_noise(self, w, U, *, eta, rng):
        """U += n, w += eta * n with n ~ N(0, (dp_clip * dp_sigma)^2) per
        coordinate, one key per leaf from ``split(rng, n_leaves)`` in
        jax's leaf order; ``w``'s leaves keep their dtype."""
        if self.dp_sigma <= 0.0:
            return w, U
        flat = tree.leaves(U)
        keys = prng.split(rng, len(flat))
        scale = self.dp_clip * self.dp_sigma
        noise = tree.unflatten(U, [
            scale * prng.normal(k, tuple(l.shape), device=l.device)
            for k, l in zip(keys, flat)])
        U = tree.tree_map(lambda u, n: u + n, U, noise)
        w = tree.tree_map(
            lambda p, n: (p + eta * n.to(p.dtype)).to(p.dtype), w, noise)
        return w, U

    def metrics(self, w) -> Dict[str, float]:
        """Eval loss of ``w`` on a fixed probe batch: the (client 0,
        round 0, iteration 0) batch, the same in every engine for the same
        ``data_fn``, through the default kernel route under no grad."""
        dev = tree.leaves(w)[0].device
        if self._eval_batch is None:
            self._eval_batch = self.data_fn(0, 0, 0, prng.PRNGKey(0))
        with torch.no_grad():
            loss = train_loss(self.cfg, w,
                              self._batch_on(self._eval_batch, dev),
                              remat=self.remat)
        out = {"loss": float(loss)}
        if self.last_loss is not None:
            out["last_train_loss"] = self.last_loss
        return out
