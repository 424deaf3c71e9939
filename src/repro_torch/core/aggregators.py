"""Hierarchical aggregator tree (paper Supp. A remark; the reference's
``repro/core/aggregators.py`` over the port's params dicts).

"We may think of the server as a number of connected separate aggregators
that serve as proxies between the clients and server … Extra layers of
aggregators allows us to satisfy network throughput constraints (at the
price of added communication latency)."

An aggregator sums the U_{i,c} of its child clients per round before
forwarding ONE message upstream — the server's per-round inbound message
count drops from n_clients to n_aggregators.  Here it is an explicit
protocol object usable in the simulator, with per-round byte
accounting.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.protocol import UpdateMsg
from repro_torch.tree import tree_map


class Aggregator:
    """Sums child updates per round; emits one upstream UpdateMsg."""

    def __init__(self, agg_id: int, child_ids: Sequence[int]):
        self.id = agg_id
        self.children = set(child_ids)
        # round -> {c: (U, k_send)}
        self.pending: Dict[int, Dict[int, Any]] = {}
        self.forwarded: List[int] = []

    def receive(self, msg: UpdateMsg) -> Optional[UpdateMsg]:
        assert msg.client_id in self.children, \
            f"client {msg.client_id} not assigned to aggregator {self.id}"
        bucket = self.pending.setdefault(msg.round_idx, {})
        bucket[msg.client_id] = (msg.U, msg.k_send)
        if set(bucket) == self.children:
            total = None
            for U, _ks in bucket.values():
                total = U if total is None else tree_map(
                    lambda a, b: a + b, total, U)
            # forward the bucket's MINIMUM k_send — the conservative
            # (largest) staleness of any summed child update, so the
            # staleness-at-apply census never under-reports an
            # aggregator-tree run (k_send previously defaulted to 0,
            # i.e. garbage tau = server_k for every aggregate)
            k_send = min(ks for _U, ks in bucket.values())
            del self.pending[msg.round_idx]
            self.forwarded.append(msg.round_idx)
            # encode the aggregate as a synthetic "client" = aggregator id
            return UpdateMsg(round_idx=msg.round_idx,
                             client_id=self.id, U=total, k_send=k_send)
        return None


def build_tree(n_clients: int, fan_in: int) -> List[Aggregator]:
    """One aggregator per fan_in consecutive clients."""
    aggs = []
    for a, start in enumerate(range(0, n_clients, fan_in)):
        aggs.append(Aggregator(a, range(start,
                                        min(start + fan_in, n_clients))))
    return aggs


def tree_message_counts(n_clients: int, fan_in: int, T: int) -> dict:
    """Messages per link level for T rounds (throughput planning)."""
    n_aggs = -(-n_clients // fan_in)
    return {
        "client_to_aggregator": n_clients * T,
        "aggregator_to_server": n_aggs * T,
        "server_inbound_reduction": n_clients / n_aggs,
    }
