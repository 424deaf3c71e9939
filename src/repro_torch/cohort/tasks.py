"""Batched (cohort) task adapter: per-round client compute with a leading
client axis.

``CohortLogRegTask`` advances the whole population's flat ``[C, D]``
blocks (``w`` then ``b``, D = d + 1) by up to ``block`` single-sample
SGD steps in one call.  The reference's ``vmap``-of-``scan`` becomes a
Python loop over the block steps on ``[C, D]`` tensors, masked by
``j < n[c]``.  Sample draws are addressed by (client, round, iteration)
exactly as ``LogRegTask`` derives them, and drawn for all ``[C, block]``
steps before the loop.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from repro_torch import prng
from repro_torch.core.tasks import LogRegTask
from repro_torch.models import logreg


def _clip_pairs(gw: torch.Tensor, gb: torch.Tensor, clip: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``clip_tree`` of each client's (w, b) gradient
    pair, over the client axis: gw [C, d], gb [C], the norm over ``w``
    and ``b`` together, summed in the reference's leaf order (``b``
    first)."""
    norm = torch.sqrt(gb * gb + (gw * gw).sum(dim=-1))
    scale = 1.0 / torch.clamp(norm / clip, min=1.0)
    return gw * scale[..., None], gb * scale


def _client_view(task, lo: int, hi: int):
    """A shallow copy of a cohort task holding clients ``[lo, hi)``: its
    per-client keys sliced, everything else shared."""
    if not 0 <= lo < hi <= task.C:
        raise ValueError(f"client range [{lo}, {hi}) outside {task.C}")
    if (lo, hi) == (0, task.C):
        return task
    view = copy.copy(task)
    view.C = hi - lo
    view.base_keys = task.base_keys[lo:hi]
    return view


class CohortLogRegTask:
    """Whole-population view of ``LogRegTask`` (the paper's experiments)
    on ``device``."""

    def __init__(self, task: LogRegTask, n_clients: int, *, seed: int = 0,
                 device=None):
        self.task = task
        self.device = torch.device(device)
        self.C = int(n_clients)
        self.d_feat = task.d
        self.D = task.d + 1                     # w (d) then b (1), flat
        base_seed = (task.sample_seed if task.sample_seed is not None
                     else seed)
        self.base_keys = prng.fold_in(
            prng.PRNGKey(base_seed, device=self.device),
            torch.arange(self.C, device=self.device))
        self.X, self.y = task.on(self.device)

    def for_clients(self, lo: int, hi: int) -> "CohortLogRegTask":
        """The task over clients ``[lo, hi)`` of the population: its
        draws keyed by the global client index, the data shared."""
        return _client_view(self, lo, hi)

    # -- flat layout -------------------------------------------------------
    def flatten(self, m) -> torch.Tensor:
        return torch.cat([m["w"].to(torch.float32).reshape(-1),
                          m["b"].to(torch.float32).reshape(1)]).to(
                              self.device)

    def unflatten(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"w": vec[:self.d_feat], "b": vec[self.d_feat]}

    def init_flat(self) -> torch.Tensor:
        return self.flatten(self.task.init_model())

    def metrics(self, vec: torch.Tensor) -> Dict[str, float]:
        return self.task.metrics(self.unflatten(vec))

    # -- batched compute ---------------------------------------------------
    def sample_idx(self, i: torch.Tensor, h: torch.Tensor,
                   block: int) -> torch.Tensor:
        """[C, block] sample indices: the first word of
        ``fold_in(fold_in(base_keys[c], i[c]), h[c] + j)`` mod n."""
        round_keys = prng.fold_in(self.base_keys, i)              # [C, 2]
        j = torch.arange(block, device=self.device)
        keys = prng.fold_in(round_keys[:, None, :],
                            h.to(torch.int64)[:, None] + j[None, :])
        return keys[..., 0] % self.X.shape[0]

    def run_block(self, w, U, i, h, n, eta, block: int,
                  idx: Optional[torch.Tensor] = None):
        """Advance every client by up to ``block`` local SGD iterations.

        w, U: [C, D]; i, h, n: [C] int (round, in-round offset,
        iterations to take this call); eta: [C] f32 round step sizes.
        Steps j >= n[c] are masked no-ops (gradient times 0)."""
        if idx is None:
            idx = self.sample_idx(i, h, block)
        d = self.d_feat
        l2, clip = self.task.l2, self.task.dp_clip
        pw, pb = w[:, :d], w[:, d]
        uw, ub = U[:, :d], U[:, d]
        eta_w = eta[:, None]
        for j in range(block):
            ij = idx[:, j]
            gw, gb = logreg.per_example_grad(pw, pb, self.X[ij], self.y[ij],
                                             l2)
            if clip > 0.0:
                gw, gb = _clip_pairs(gw, gb, clip)
            act = (j < n).to(torch.float32)
            gw = act[:, None] * gw
            gb = act * gb
            uw = uw + gw
            ub = ub + gb
            pw = pw - eta_w * gw
            pb = pb - eta * gb
        return (torch.cat([pw, pb[:, None]], dim=1),
                torch.cat([uw, ub[:, None]], dim=1))
