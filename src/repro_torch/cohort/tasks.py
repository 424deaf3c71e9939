"""Batched (cohort) task adapter: per-round client compute with a leading
client axis.

``CohortLogRegTask`` advances the whole population's flat ``[C, D]``
blocks (``w`` then ``b``, D = d + 1) by up to ``block`` single-sample
SGD steps in one call.  The reference's ``vmap``-of-``scan`` becomes one
``cohort_logreg_block`` launch on the card (its plain twin on the CPU),
which runs each client's own ``n[c]`` steps and no more.  Sample draws
are addressed by (client, round, iteration) exactly as ``LogRegTask``
derives them, and drawn for all ``[C, block]`` steps before the launch.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from repro_torch import prng
from repro_torch.core.tasks import LogRegTask
from repro_torch.kernels.cohort_block import logreg_block


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

    #: the device engine's span recorder (``DeviceCohortEngine.spans``);
    #: each kernel launch of ``run_block`` is appended to its ``launches``
    spans = None

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
        Client ``c`` takes ``min(n[c], block)`` steps; the rows of a
        client with ``n[c] = 0`` come back unchanged."""
        if idx is None:
            idx = self.sample_idx(i, h, block)
        l2, clip = self.task.l2, self.task.dp_clip
        if self.spans is not None and w.is_cuda:
            self.spans.launches.append(("cohort_logreg_block", dict(
                C=w.shape[0], D=w.shape[1], b=block, clip=clip, l2=l2)))
        return logreg_block(w, U, idx, n, eta, self.X, self.y, l2=l2,
                            clip=clip)
