"""Task abstraction: the computation a client performs inside a round.

``LogRegTask`` reproduces the paper's experiments: per-iteration
single-sample SGD (Algorithm 1 lines 15-21), optional per-sample gradient
clipping (line 17) and round Gaussian noise (lines 23-24).  The port
keeps its ``sample_seed`` mode, in which the sample drawn at (client,
round, iteration) is a pure function of that address, so trajectories
are reproducible across engines and against the JAX reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import logreg


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

    def metrics(self, params) -> Dict[str, float]:
        X, y = self.on(params["w"].device)
        return {"loss": float(logreg.batch_loss(params, X, y, self.l2)),
                "accuracy": float(logreg.accuracy(params, X, y))}
