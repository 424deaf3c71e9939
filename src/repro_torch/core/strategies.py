"""Server-side aggregation strategies (``repro/core/strategies.py``).

* ``PaperStrategy`` (default) — the paper's apply-on-dequeue server
  (Algorithm 3): every arriving update is applied with weight 1.
* ``FedAsyncStrategy`` — staleness-decayed alpha-mixing: an update sent
  against broadcast counter ``k_send`` and applied at server counter
  ``k`` is weighted ``alpha * s(tau)``, ``tau = k - k_send``, with ``s``
  one of ``constant`` / ``hinge`` / ``poly``.
* ``FedBuffStrategy`` — arriving updates bank in a server-side buffer
  applied to the model every ``buffer_size`` updates.

Everything but the application of arriving vectors is strategy-
invariant, so one seed gives the same message schedule under every
strategy.  ``decay_weights`` maps an int staleness tensor to f32 weights
with the reference's f32 arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch


def ring_decay(strategy, server_k: int, R: int, device=None) -> torch.Tensor:
    """[R] decay weights for the sender-k ring strata at server counter
    ``server_k``: stratum r holds updates sent against broadcast counter
    ``r (mod R)``, so its staleness is ``(server_k - r) mod R`` — exact
    because the wait gate bounds true staleness by d - 1 < R."""
    tau = (int(server_k) - torch.arange(R, dtype=torch.int32,
                                        device=device)) & (R - 1)
    return strategy.decay_weights(tau)


class AggregationStrategy:
    """Base class AND the paper's default apply-on-dequeue rule."""

    #: strategy id, used in fingerprints / benchmark rows
    kind: str = "paper"
    #: engines bucket update vectors per sender-k and decay at apply time
    stratified: bool = False
    #: engines accumulate applied vectors and flush every buffer_size
    buffered: bool = False

    def weight(self, tau: int) -> float:
        """Decay weight for one update applied at staleness ``tau``."""
        return 1.0

    def decay_weights(self, tau: torch.Tensor) -> torch.Tensor:
        """[R] int staleness -> [R] f32 weights."""
        return torch.ones(tau.shape, dtype=torch.float32, device=tau.device)

    def fingerprint(self) -> Tuple[Any, ...]:
        return (self.kind,)

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self.fingerprint()[1:]}"


PaperStrategy = AggregationStrategy

#: FedAsync decay families (FLGo's fedasync server option vocabulary)
FEDASYNC_DECAYS = ("constant", "hinge", "poly")


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True, repr=False)
class FedAsyncStrategy(AggregationStrategy):
    """Staleness-decayed alpha-mixing: apply ``alpha * s(tau) * eta * U``.

    ``s(tau)`` per ``decay`` (FLGo defaults):
      constant  s = 1
      hinge     s = 1 if tau <= hinge_b else 1 / (hinge_a*(tau-hinge_b)+1)
      poly      s = (tau + 1) ** -poly_a
    """
    alpha: float = 0.6
    decay: str = "poly"
    hinge_a: float = 10.0
    hinge_b: int = 6
    poly_a: float = 0.5

    kind = "fedasync"
    stratified = True

    def __post_init__(self):
        if self.decay not in FEDASYNC_DECAYS:
            raise ValueError(f"FedAsync decay {self.decay!r} not in "
                             f"{FEDASYNC_DECAYS}")

    def weight(self, tau: int) -> float:
        """``alpha * s(tau)`` in Python floats, tau clamped at 0 — the
        event simulator's server weight for one update."""
        t = float(max(tau, 0))
        if self.decay == "constant":
            s = 1.0
        elif self.decay == "hinge":
            s = (1.0 if t <= self.hinge_b
                 else 1.0 / (self.hinge_a * (t - self.hinge_b) + 1.0))
        else:
            s = (t + 1.0) ** (-self.poly_a)
        return self.alpha * s

    def decay_weights(self, tau: torch.Tensor) -> torch.Tensor:
        tf = tau.to(torch.float32)
        alpha = torch.tensor(_f32(self.alpha), device=tau.device)
        if self.decay == "constant":
            return torch.full(tau.shape, _f32(self.alpha),
                              dtype=torch.float32, device=tau.device)
        if self.decay == "hinge":
            a, b = _f32(self.hinge_a), _f32(self.hinge_b)
            return torch.where(tf <= b, alpha, alpha / (a * (tf - b) + 1.0))
        # a tensor exponent: a scalar -0.5 would take torch's rsqrt path,
        # which rounds unlike XLA's pow
        return alpha * torch.pow(tf + 1.0, torch.tensor(
            -_f32(self.poly_a), device=tau.device))

    def fingerprint(self) -> Tuple[Any, ...]:
        return ("fedasync", self.alpha, self.decay, self.hinge_a,
                self.hinge_b, self.poly_a)


@dataclass(frozen=True, repr=False)
class FedBuffStrategy(AggregationStrategy):
    """Buffered aggregation: ``v -= buffer`` every ``buffer_size``
    arriving updates.  A partial buffer at run end is dropped."""
    buffer_size: int = 4

    kind = "fedbuff"
    buffered = True

    def __post_init__(self):
        if self.buffer_size < 1:
            raise ValueError("FedBuff buffer_size must be >= 1")

    def fingerprint(self) -> Tuple[Any, ...]:
        return ("fedbuff", self.buffer_size)


_BY_KIND = {"paper": PaperStrategy, "fedasync": FedAsyncStrategy,
            "fedbuff": FedBuffStrategy}


def get_strategy(spec=None) -> AggregationStrategy:
    """Resolve ``None`` | kind name | ``{"kind": ..., **hparams}`` |
    strategy instance to an ``AggregationStrategy``."""
    if spec is None:
        return PaperStrategy()
    if isinstance(spec, AggregationStrategy):
        return spec
    if isinstance(spec, str):
        kind, spec = spec, {}
    elif isinstance(spec, dict):
        spec = dict(spec)
        kind = spec.pop("kind", "paper")
    else:
        raise TypeError(f"cannot resolve aggregation strategy from "
                        f"{spec!r} (want None, a kind name, a dict, or "
                        f"an AggregationStrategy)")
    cls = _BY_KIND.get(kind)
    if cls is None:
        raise ValueError(f"unknown aggregation strategy {kind!r} "
                         f"(want one of {sorted(_BY_KIND)})")
    return cls(**spec)
