"""Task abstraction: the computation a client performs inside a round.

``LogRegTask`` reproduces the paper's experiments: per-iteration
single-sample SGD (Algorithm 1 lines 15-21), optional per-sample gradient
clipping (line 17) and round Gaussian noise (lines 23-24).  The port
keeps its ``sample_seed`` mode, in which the sample drawn at (client,
round, iteration) is a pure function of that address, so trajectories
are reproducible across engines and against the JAX reference.

The event simulator runs one client at a time through
``run_iterations`` / ``add_round_noise`` on ``{"w": [d], "b": []}``
params on the engine's device: the reference's jitted power-of-two
chunks of ``lax.scan`` become a loop of torch ops per step, with the
chunks kept where they address the sample draws (one key split per
chunk without ``sample_seed``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models import logreg


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over a params dict, leaves in jax's
    order (sorted keys)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].to(torch.float32)))
                          for k in sorted(tree)))


def clip_tree(gw: torch.Tensor, gb: torch.Tensor, clip: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale each (w, b) gradient pair to global norm <= ``clip``.

    gw [..., d], gb [...]: the norm is taken over ``w`` and ``b`` together,
    summed in the reference's leaf order (``b`` first)."""
    norm = torch.sqrt(gb * gb + (gw * gw).sum(dim=-1))
    scale = 1.0 / torch.clamp(norm / clip, min=1.0)
    return gw * scale[..., None], gb * scale


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
                gw, gb = clip_tree(gw, gb, self.dp_clip)
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
