"""MetricsReport — the telemetry schema of the reference's engines.

The paper's headline claims are *fewer rounds* and *less aggregated
Gaussian noise*; both are communication/privacy statements, so the
report is built around three integer counter families that every engine
must agree on:

  * communication census — per-client update messages sent
    (``participation``) and bytes on the wire (``bytes_up``); downlink
    bytes are derived, since every fired broadcast fans out to the full
    fleet (Algorithm 3 broadcasts to all clients).
  * staleness-at-apply — for each applied update, how many server
    rounds elapsed between the sender's freshest-seen broadcast counter
    ``k`` at send time and the server's completed-round counter when the
    update is folded into ``v``.  The wait gate (Supp. B.2) bounds this
    by ``d - 1``, so the histogram doubles as a runtime check of the
    gate.  Binned into ``STALE_BINS`` fixed bins (last bin is
    overflow) so the device engine can hold it as a fixed-shape array
    on the device.
  * overflow-bucket high-water mark — peak simultaneous occupancy of
    the device engine's far-tier arrival slots (host engines report the
    equivalent: peak pending far-tick buckets), the datum for tuning
    ``Scenario.ring_cap``.

Wire model: payloads travel as float32, one element per flat model
coordinate, plus a fixed ``HEADER_BYTES`` envelope (round, client, k,
length).  Integer byte counts are therefore exact and engine-invariant.

Counter contract: ``participation``, ``bytes_up``, ``messages``,
``broadcasts`` and ``staleness_hist`` of each of the port's three
engines are exactly equal to the JAX reference engine's on the same
configuration; the two cohort engines' are bitwise equal to each other,
and equal to the event simulator's at ``d = 1`` under deterministic
scenarios.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.telemetry.costs import ops_dict

# Fixed number of staleness bins: bins 0..STALE_BINS-2 count exact
# staleness values, the last bin absorbs everything >= STALE_BINS-1.
STALE_BINS = 8
# Message envelope: (round, client, k, payload length) as 4 x int32.
HEADER_BYTES = 16
F32_BYTES = 4


def update_msg_bytes(flat_dim: int) -> int:
    """Bytes on the wire for one client->server update message."""
    return HEADER_BYTES + F32_BYTES * int(flat_dim)


def broadcast_msg_bytes(flat_dim: int) -> int:
    """Bytes on the wire for one server->client broadcast copy."""
    return HEADER_BYTES + F32_BYTES * int(flat_dim)


def model_flat_dim(model: Any) -> int:
    """Total scalar count of a model's params (a dict of tensors)."""
    from repro_torch.tree import leaves
    return int(sum(int(np.prod(tuple(leaf.shape))) for leaf in leaves(model)))


def staleness_bin(tau: int) -> int:
    return min(int(tau), STALE_BINS - 1)


@dataclass
class MetricsReport:
    """Uniform cross-engine telemetry record.

    Integer counters are numpy int64 arrays / Python ints; everything an
    engine cannot measure stays at its zero/None default, so reports
    from different engines share one schema.
    """
    engine: str                      # "event" | "host" | "device"
    clients: int
    flat_dim: int
    rounds: int                      # server completed-round counter
    messages: int                    # client->server updates sent
    broadcasts: int                  # server broadcasts fired
    update_msg_bytes: int
    broadcast_msg_bytes: int
    participation: np.ndarray        # [C] int64 — updates sent per client
    bytes_up: np.ndarray             # [C] int64 — uplink bytes per client
    bytes_down: np.ndarray           # [C] int64 — downlink bytes per client
    staleness_hist: np.ndarray       # [STALE_BINS] int64 — at-apply bins
    overflow_hwm: int = 0            # peak far-tier arrival-slot occupancy
    overflow_slots: Optional[int] = None   # device capacity (Q); None=host
    far_messages: int = 0            # updates that landed in the far tier
    ticks: Optional[int] = None      # cohort engines only
    virtual_time: Optional[float] = None   # event sim only (seconds)
    dp: Optional[List[Dict[str, Any]]] = None  # per-client accounting rows
    wall: Dict[str, float] = field(default_factory=dict)  # profiling
    # op census (telemetry.costs): which tick-loop operations ran,
    # keyed by costs.OP_NAMES — cohort engines only, bitwise
    # host-vs-device like the counters above
    ops: Optional[Dict[str, int]] = None

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, np.ndarray):
                out[f.name] = [int(x) for x in val]
            elif isinstance(val, (np.integer,)):
                out[f.name] = int(val)
            elif isinstance(val, (np.floating,)):
                out[f.name] = float(val)
            else:
                out[f.name] = val
        return out

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **kw)

    def summary(self) -> str:
        """One-paragraph human summary (for examples / logs)."""
        up = int(self.bytes_up.sum())
        down = int(self.bytes_down.sum())
        hist = "/".join(str(int(x)) for x in self.staleness_hist)
        lines = [
            f"[{self.engine}] rounds={self.rounds} "
            f"messages={self.messages} broadcasts={self.broadcasts}",
            f"  bytes up={up} down={down} "
            f"(msg={self.update_msg_bytes}B, bcast={self.broadcast_msg_bytes}B)",
            f"  staleness hist [0..{STALE_BINS - 2},{STALE_BINS - 1}+]: {hist}",
            f"  overflow hwm={self.overflow_hwm}"
            + (f"/{self.overflow_slots}" if self.overflow_slots else "")
            + f" far_messages={self.far_messages}",
        ]
        if self.dp:
            eps = [r["epsilon"] for r in self.dp if r["epsilon"] is not None]
            if eps:
                lines.append(f"  dp: max per-client epsilon={max(eps):.4g} "
                             f"over {len(self.dp)} clients")
        if self.ops:
            frag = " ".join(f"{k}={int(v)}" for k, v in self.ops.items())
            lines.append(f"  ops: {frag}")
        if self.wall:
            # phase entries are seconds (``_s``); their span counts
            # (``_n``, see SpanRecorder.as_dict) are plain integers
            frag = " ".join(
                f"{k}={v:.3g}s" if k.endswith("_s") else f"{k}={int(v)}"
                for k, v in self.wall.items())
            lines.append(f"  wall: {frag}")
        return "\n".join(lines)


def participation_sizes(sizes_per_client: Sequence[Sequence[int]],
                        participation: Sequence[int]
                        ) -> List[List[int]]:
    """Per-client list of sample sizes for the rounds actually sent.

    ``sizes_per_client[c]`` is the round-schedule s_{i,c} (the last entry
    repeats past the end, matching ``Client.s``); the returned row for
    client c has exactly ``participation[c]`` entries — the sample sizes
    the moments accountant must charge for that client.
    """
    rows: List[List[int]] = []
    for c, done in enumerate(participation):
        sched = list(sizes_per_client[c])
        rows.append([sched[min(i, len(sched) - 1)] for i in range(int(done))])
    return rows


def build_report(*, engine: str, clients: int, flat_dim: int, rounds: int,
                 messages: int, broadcasts: int,
                 participation: np.ndarray, bytes_up: np.ndarray,
                 staleness_hist: np.ndarray,
                 overflow_hwm: int = 0, overflow_slots: Optional[int] = None,
                 far_messages: int = 0,
                 ticks: Optional[int] = None,
                 virtual_time: Optional[float] = None,
                 dp_sigma: float = 0.0, dp_delta: float = 1e-5,
                 n_examples: Optional[int] = None,
                 sizes_per_client: Optional[Sequence[Sequence[int]]] = None,
                 wall: Optional[Dict[str, float]] = None,
                 ops=None) -> MetricsReport:
    """Assemble a MetricsReport from raw engine counters.

    Derives bytes_down (every fired broadcast reaches the whole fleet)
    and, when ``dp_sigma > 0`` and the dataset size is known, the
    per-client DP accounting rows from the rounds each client actually
    contributed.
    """
    ub = update_msg_bytes(flat_dim)
    bb = broadcast_msg_bytes(flat_dim)
    part = np.asarray(participation, dtype=np.int64)
    bup = np.asarray(bytes_up, dtype=np.int64)
    bdown = np.full(clients, int(broadcasts) * bb, dtype=np.int64)
    dp_rows = None
    if (dp_sigma > 0 and n_examples is not None
            and sizes_per_client is not None and len(sizes_per_client)):
        from repro_torch.dp.accountant import per_client_accounting
        rows = participation_sizes(sizes_per_client, part)
        dp_rows = per_client_accounting(rows, n_examples, dp_sigma, dp_delta)
    return MetricsReport(
        engine=engine, clients=int(clients), flat_dim=int(flat_dim),
        rounds=int(rounds), messages=int(messages),
        broadcasts=int(broadcasts),
        update_msg_bytes=ub, broadcast_msg_bytes=bb,
        participation=part, bytes_up=bup, bytes_down=bdown,
        staleness_hist=np.asarray(staleness_hist, dtype=np.int64),
        overflow_hwm=int(overflow_hwm), overflow_slots=overflow_slots,
        far_messages=int(far_messages), ticks=ticks,
        virtual_time=virtual_time, dp=dp_rows, wall=dict(wall or {}),
        ops=(ops if isinstance(ops, dict) or ops is None
             else ops_dict(ops)))
