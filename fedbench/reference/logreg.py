"""The paper's logistic regression, plainly: the starting model and a
client's local steps (arXiv:2007.09208 Supp. E, Algorithm 1 lines 15-21).

One local step of client ``c`` at offset ``h`` of round ``i`` draws
example ``fold_in(fold_in(fold_in(key(base_seed), c), i), h)[0] mod N``,
takes the gradient of ``BCE(sigmoid(x.w + b), y) + l2/2 |w|^2``, clips
the (w, b) gradient to norm ``clip`` and takes ``U += g``,
``w -= eta * g``.  The starting model is ``0.01 * normal`` under key 0
for ``w`` and 0 for ``b``.
"""
from __future__ import annotations

import numpy as np
import torch

from fedbench.reference import threefry


def init_model(d: int, device) -> torch.Tensor:
    """[d + 1]: w then b."""
    w = 0.01 * threefry.normal(threefry.key(0), 0, d, device)
    return torch.cat([w, torch.zeros(1, device=device)])


class LocalSteps:
    """``block_fn`` of ``PlainCohort`` for the logistic regression on
    (X, y), computed in ``dtype``."""

    def __init__(self, X, y, *, C: int, base_seed: int, l2: float,
                 clip: float, dtype=torch.float32):
        self.X, self.y = X.to(dtype), y.to(dtype)
        self.N, self.d = X.shape
        self.l2, self.clip = float(l2), float(clip)
        cid = torch.arange(C, dtype=torch.int64, device=X.device)
        self.base = threefry.fold_in(threefry.key(base_seed), cid)

    def __call__(self, w, U, i, h, n, eta):
        dev = w.device
        i_t = torch.as_tensor(i, device=dev)
        h_t = torch.as_tensor(h, device=dev)
        n_t = torch.as_tensor(n, device=dev)
        round_key = threefry.fold_in(self.base, i_t)
        d = self.d
        for j in range(int(np.max(n))):
            rows = torch.nonzero(n_t > j)[:, 0]
            k0, _ = threefry.fold_in((round_key[0][rows], round_key[1][rows]),
                                     h_t[rows] + j)
            ex = k0 % self.N
            x, y = self.X[ex], self.y[ex]
            wr = w[rows]
            z = (x * wr[:, :d]).sum(-1) + wr[:, d]
            dz = torch.sigmoid(z) - y
            gw = dz[:, None] * x + self.l2 * wr[:, :d]
            norm = torch.sqrt((gw * gw).sum(-1) + dz * dz)
            s = 1.0 / torch.clamp(norm / self.clip, min=1.0)
            g = torch.cat([gw * s[:, None], (dz * s)[:, None]], dim=1)
            U[rows] = U[rows] + g
            w[rows] = wr - eta[rows, None] * g
