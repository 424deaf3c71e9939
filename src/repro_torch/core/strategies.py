"""Server-side aggregation strategies.

The port runs the paper's apply-on-dequeue server (Algorithm 3):
every arriving update is applied with weight 1.  FedAsync and FedBuff
(``repro.core.strategies``) are ROADMAP Queue 1 item 8 and raise here.
"""
from __future__ import annotations

from typing import Any, Tuple


class AggregationStrategy:
    """The paper's default apply-on-dequeue rule."""

    kind: str = "paper"
    stratified: bool = False
    buffered: bool = False

    def weight(self, tau: int) -> float:
        return 1.0

    def fingerprint(self) -> Tuple[Any, ...]:
        return (self.kind,)

    def __repr__(self) -> str:
        return f"{type(self).__name__}{self.fingerprint()[1:]}"


PaperStrategy = AggregationStrategy


def get_strategy(spec=None) -> AggregationStrategy:
    """Resolve ``None`` | ``"paper"`` | ``{"kind": "paper"}`` | instance."""
    if spec is None:
        return PaperStrategy()
    if isinstance(spec, AggregationStrategy):
        return spec
    if isinstance(spec, str):
        kind = spec
    elif isinstance(spec, dict):
        kind = spec.get("kind", "paper")
    else:
        raise TypeError(f"cannot resolve aggregation strategy from "
                        f"{spec!r} (want None, a kind name, a dict, or "
                        f"an AggregationStrategy)")
    if kind in ("fedasync", "fedbuff"):
        raise NotImplementedError(
            f"aggregation strategy {kind!r} is not ported yet "
            "(ROADMAP Queue 1 item 8: FedAsync and FedBuff)")
    if kind != "paper":
        raise ValueError(f"unknown aggregation strategy {kind!r}")
    return PaperStrategy()
