"""Optimizers over params trees (the port's copy of ``repro.optim.sgd``).

The paper's server update is plain SGD with round step sizes; momentum
and AdamW are provided for the non-convex architectures (§C.3 regime).
State and arithmetic are f32; params keep their dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

F32 = torch.float32


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(tuple(p.shape), dtype=F32, device=p.device)


class SGDState(NamedTuple):
    momentum: Optional[Any]


class AdamState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


@dataclass(frozen=True)
class SGD:
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params) -> SGDState:
        if self.momentum == 0.0:
            return SGDState(momentum=None)
        return SGDState(momentum=tree_map(_zeros, params))

    def update(self, grads, state: SGDState, params, lr
               ) -> Tuple[Any, SGDState]:
        if state.momentum is None:
            new_params = tree_map(
                lambda p, g: (p.to(F32) - lr * g.to(F32)).to(p.dtype),
                params, grads)
            return new_params, state
        m = tree_map(lambda mm, g: self.momentum * mm + g.to(F32),
                     state.momentum, grads)
        upd = m
        if self.nesterov:
            upd = tree_map(lambda mm, g: self.momentum * mm + g.to(F32),
                           m, grads)
        new_params = tree_map(lambda p, u: (p.to(F32) - lr * u).to(p.dtype),
                              params, upd)
        return new_params, SGDState(momentum=m)


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamState:
        return AdamState(mu=tree_map(_zeros, params),
                         nu=tree_map(_zeros, params),
                         count=torch.zeros((), dtype=torch.int32,
                                           device=leaves(params)[0].device))

    def update(self, grads, state: AdamState, params, lr
               ) -> Tuple[Any, AdamState]:
        count = state.count + 1
        b1c = 1.0 - self.b1 ** count.to(F32)
        b2c = 1.0 - self.b2 ** count.to(F32)
        mu = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g.to(F32),
                      state.mu, grads)
        nu = tree_map(lambda v, g: self.b2 * v
                      + (1 - self.b2) * torch.square(g.to(F32)),
                      state.nu, grads)

        def upd(p, m, v):
            step = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.to(F32)
            return (p.to(F32) - lr * step).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, AdamState(mu=mu, nu=nu, count=count)
