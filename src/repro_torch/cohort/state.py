"""Cohort-engine state: the host engine's and the device-resident one.

``CohortState`` is the host-loop engine's population (``repro_torch.
cohort.engine``): the ``[C, D]`` blocks ``w``/``U`` and the server model
``v`` as tensors on the engine's device, the per-client protocol
counters (round ``i``, in-round iteration ``h``, freshest broadcast
``k``, iteration credit) as numpy int64 on the host, where they drive
the Python control flow of every tick.  Its messages are metadata plus
payload: ``UpdateBuckets`` keeps in-flight updates pre-weighted and
summed by arrival tick (near ring and far tier), with the (round,
client, k_send) triples Algorithm 3's H set needs as host metadata;
``BroadcastRing`` the few outstanding broadcasts.

``DeviceCohortState`` holds the whole protocol on the device — the
population blocks ``w``/``U`` ``[C, D]``, the per-client counters, the
message buffers as fixed-capacity ring tensors and the telemetry
counters — as one NamedTuple of tensors with the reference's field names
and dtypes (``repro.cohort.state``), so a numpy copy of the reference's
state converts field by field (``repro_torch.convert.state_from_jax``).
Over a ``clients`` mesh a rank holds its rows of the ``[C, ...]``
fields; ``dtensor_views`` shows them as DTensors placed as the
reference's ``cohort_shardings``.

Iteration credit is int32 fixed point (``FRAC_BITS`` fractional bits),
as in the reference: float credit would accumulate differently across
engines, and a single divergent ``floor(credit)`` changes the schedule.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np

FRAC_BITS = 16   # fixed-point fractional bits of the iteration credit


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (ring capacities, block sizes)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def speed_accrual(speeds, block: int) -> np.ndarray:
    """Per-tick integer credit earned by each client.

    dt = block / max(speed), so client c earns ``speed_c / max(speed) *
    block`` iterations per tick; quantized to FRAC_BITS so both engines
    accrue the exact same integers.
    """
    s = np.asarray(speeds, np.float64)
    ispeed = np.maximum(1, np.round(s / s.max() * (1 << FRAC_BITS)))
    return ispeed.astype(np.int64) * int(block)


def pad_sizes(sizes_per_client, n_clients: int) -> np.ndarray:
    """Per-client round sizes as a dense [C, L] array, s(i) = s[min(i, L-1)].

    Shared by both cohort engines so their schedules stay identical.
    """
    if isinstance(sizes_per_client[0], (list, tuple)):
        per_client = [list(s) for s in sizes_per_client]
    else:
        per_client = [list(sizes_per_client)] * n_clients
    L = max(len(s) for s in per_client)
    sizes = np.empty((n_clients, L), np.int64)
    for c, s in enumerate(per_client):
        sizes[c, :len(s)] = s
        sizes[c, len(s):] = s[-1]
    return sizes


def default_max_ticks(sizes: np.ndarray, speeds: np.ndarray, block: int,
                      max_rounds: int, *, lat_tail_ticks: int = 1,
                      duty: float = 1.0) -> int:
    """Stall-detection tick budget, shared by both cohort engines.

    dt is sized for the FASTEST client (dt = block / max speed), so the
    slowest one earns only block * min/max credit per tick and needs
    speed_ratio times more ticks than s/block suggests; the budget must
    also cover the LARGEST round of an increasing schedule, not round 0.
    Scenario terms: every round waits one update + one broadcast trip,
    so the budget carries 2x the latency table's TAIL tick count (not
    the mean — a heavy-tailed table otherwise trips the guard), and an
    availability duty cycle < 1 stretches every compute tick by 1/duty.
    """
    speed_ratio = float(speeds.max() / speeds.min())
    compute = int(sizes.max()) / block * speed_ratio / max(duty, 1e-3)
    per_round = int(math.ceil(compute)) + 8 + 2 * int(lat_tail_ticks)
    return max(1000, max_rounds * per_round * 16)


class DeviceCohortState(NamedTuple):
    """Whole protocol state on device — counters, models, message rings.

    Message buffers are fixed-capacity power-of-two rings (capacities
    chosen in ``repro_torch.cohort.device``):

      * update ring, L slots (L > max latency ticks): ``upd_vec[t % L]``
        accumulates the pre-weighted [D] contribution arriving at tick t;
        ``upd_cnt[t % L, r % R]`` counts the arriving (round r, client)
        pairs that feed Algorithm 3's H bookkeeping.
      * H-count ring, R slots: per-round receive counts.  The wait gate
        keeps in-flight update rounds inside [server_k, server_k + d], so
        R >= next_pow2(d + 2) slots never collide.
      * broadcast ring, B slots of ((v snapshot, k), per-client arrival
        tick): an undelivered broadcast j gates every client at rounds
        <= j + d - 1, hence at most d + 1 distinct k outstanding and
        B >= next_pow2(d + 2) suffices.
      * overflow bucket, Q slots of (arrival tick, pre-weighted [D]
        vector, [R] round counts): update arrivals whose latency offset
        reaches past the L-slot ring (heavy-tailed tables under the
        ``Scenario.ring_cap`` boundary).  Entries merge by exact arrival
        tick; ``ovf_at == 0`` marks a free slot and ``err`` latches
        capacity exhaustion.  Without a far tier (every latency inside
        the ring) its fields are [1, ...] placeholders.
    """
    w: Any                 # [C, D] f32 client models
    U: Any                 # [C, D] f32 round-update accumulators
    v: Any                 # [D]    f32 server model
    i: Any                 # [C]    i32 current round
    h: Any                 # [C]    i32 iterations done in round i
    k: Any                 # [C]    i32 freshest broadcast counter seen
    credit: Any            # [C]    i32 fixed-point iteration credit
    server_k: Any          # []     i32 completed-round counter
    tick: Any              # []     i32
    upd_vec: Any           # [L, D] f32 pre-weighted arrival buckets
    upd_cnt: Any           # [L, R] i32 arriving (round, client) counts
    h_counts: Any          # [R]    i32 Algorithm 3's H, per round mod R
    bc_v: Any              # [B, D] f32 broadcast model snapshots
    bc_k: Any              # [B]    i32 broadcast round counters
    bc_at: Any             # [B, C] i32 per-client arrival ticks
    ovf_vec: Any           # [Q, D] f32 far-arrival overflow vectors
    ovf_at: Any            # [Q]    i32 overflow arrival ticks (0 = free)
    ovf_cnt: Any           # [Q, R] i32 overflow (round, client) counts
    err: Any               # []     i32 overflow-capacity error latch
    messages: Any          # []     i32 client->server updates sent
    broadcasts: Any        # []     i32 server broadcasts fired
    # telemetry (repro_torch.telemetry): census + staleness counters
    # kept on the device, read by the host only at eval segments.
    # ``upd_ks[t % L, k % R]`` / ``ovf_ks[q, k % R]`` count arrivals by
    # the SENDER's broadcast counter k at send time; staleness-at-apply
    # is decoded at pop as (server_k - k) mod R, exact because the wait
    # gate bounds it by d - 1 < R.
    part: Any              # [C]    i32 updates sent per client
    bytes_up: Any          # [C]    i32 uplink bytes per client
    stale_hist: Any        # [S]    i32 staleness-at-apply histogram
    upd_ks: Any            # [L, R] i32 arrival counts by sender k mod R
    ovf_ks: Any            # [Q, R] i32 overflow counts by sender k mod R
    ovf_hwm: Any           # []     i32 overflow occupancy high-water mark
    far_msgs: Any          # []     i32 updates routed to the far tier
    # aggregation-strategy buffers: full size only under the strategy
    # that uses them, [1, ...] placeholders otherwise.
    # ``upd_kvec``/``ovf_kvec`` are the sender-k STRATIFIED counterparts
    # of ``upd_vec``/``ovf_vec`` — FedAsync must decay each arriving
    # vector by its own staleness at apply time, so pre-summing across
    # sender-k (the paper path) would lose the needed resolution.
    # ``buf_vec``/``buf_cnt`` are FedBuff's accumulator and its arrival
    # count since the last flush.
    upd_kvec: Any          # [L, R, D] f32 arrival buckets by sender k
    ovf_kvec: Any          # [Q, R, D] f32 overflow buckets by sender k
    buf_vec: Any           # [D]       f32 FedBuff flush accumulator
    buf_cnt: Any           # []        i32 updates buffered since flush
    # op census (repro_torch.telemetry.costs): which tick-loop
    # operations ran — branch hits, delivery rows, ring scatters — one
    # cumulative i32 vector indexed by costs.OP_NAMES, advanced by the
    # tick's integer phase only, so the float math is untouched.
    ops: Any               # [N_OPS]   i32 op-census counters
    # fused-loop iteration census (``fuse_ticks``):
    # [loop_iters, block_iters] — loop iterations executed and how
    # many of them contained at least one block tick.  Protocol-neutral:
    # the ops census above still counts TICKS, this counts ITERATIONS
    # after tick coalescing, so block_iters <= loop_iters <= ticks.
    iters: Any             # [2]       i32 [loop_iters, block_iters]


def dtensor_views(st: DeviceCohortState, mesh, n_clients: int
                  ) -> DeviceCohortState:
    """``st`` (one rank's tensors) as DTensors on ``mesh``, each field
    placed as ``cohort_shardings(mesh, n_clients)`` says: a view of the
    rank's tensor (``DTensor.from_local``, no copy, no collective)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import cohort_shardings
    return DeviceCohortState(**{
        f: DTensor.from_local(getattr(st, f), m, pl, run_check=False)
        for f, (m, pl) in cohort_shardings(mesh, n_clients).items()})


@dataclass
class CohortState:
    """Host-engine population: device blocks + host counters (axis C)."""
    w: Any                 # [C, D] client models (device)
    U: Any                 # [C, D] round-update accumulators (device)
    v: Any                 # [D] server model (device)
    i: np.ndarray          # [C] current round (host, int64)
    h: np.ndarray          # [C] iterations done in round i (host)
    k: np.ndarray          # [C] freshest broadcast counter seen (host)
    credit: np.ndarray     # [C] fixed-point iteration credit (host)
    server_k: int = 0      # completed-round counter (Algorithm 3's k)
    tick: int = 0

    def blocked(self, d: int) -> np.ndarray:
        """Wait gate, vectorized: block while i >= k + d (Supp. B.2)."""
        return self.i >= self.k + d


@dataclass
class UpdateBuckets:
    """In-flight client->server updates, bucket-summed by arrival tick.

    NEAR buckets (arrival offset inside the device engine's update ring)
    and FAR ones (past it: the device engine's overflow bucket) are kept
    apart, so the host engine applies ``far + near`` in the device
    engine's order (``overflow + ring slot``).  A payload is a ``[D]``
    tensor, or ``[R, D]`` by sender k under FedAsync."""
    contrib: Dict[int, Any] = field(default_factory=dict)   # tick -> [D]
    far_contrib: Dict[int, Any] = field(default_factory=dict)
    meta: Dict[int, List[Tuple[int, int, int]]] = field(default_factory=dict)

    def add(self, tick: int, vec, pairs: List[Tuple[int, int, int]],
            far: bool = False) -> None:
        """Sum ``vec`` into the payload at ``tick`` and append its
        (round, client, k_send) triples: round/client feed Algorithm 3's
        H set, k_send the staleness-at-apply census."""
        bucket = self.far_contrib if far else self.contrib
        if tick in bucket:
            bucket[tick] = bucket[tick] + vec
        else:
            bucket[tick] = vec
        self.meta.setdefault(tick, []).extend(pairs)

    def get(self, tick: int, far: bool = False):
        """Current payload at ``tick`` (None when empty)."""
        return (self.far_contrib if far else self.contrib).get(tick)

    def put(self, tick: int, vec, pairs: List[Tuple[int, int, int]],
            far: bool = False) -> None:
        """Overwrite the payload at ``tick`` and append its (round,
        client, k_send) triples."""
        (self.far_contrib if far else self.contrib)[tick] = vec
        self.meta.setdefault(tick, []).extend(pairs)

    def pop(self, tick: int):
        """-> (far payload or None, near payload or None, triples)."""
        return (self.far_contrib.pop(tick, None),
                self.contrib.pop(tick, None), self.meta.pop(tick, []))

    def __len__(self) -> int:
        return sum(len(m) for m in self.meta.values())


@dataclass
class BroadcastRing:
    """Outstanding server->client broadcasts (few: the gate bounds the
    lag): ``{"k": int, "v": [D] tensor, "at": [C] int64 arrival ticks}``."""
    pending: List[dict] = field(default_factory=list)

    def push(self, k: int, v, arrive_ticks: np.ndarray) -> None:
        self.pending.append({"k": k, "v": v, "at": arrive_ticks})

    def due(self, tick: int):
        """Broadcasts with any arrival <= tick, ascending k."""
        return sorted((b for b in self.pending if (b["at"] <= tick).any()),
                      key=lambda b: b["k"])

    def retire(self, tick: int) -> None:
        horizon = np.iinfo(np.int64).max
        for b in self.pending:
            b["at"][b["at"] <= tick] = horizon
        self.pending = [b for b in self.pending
                        if (b["at"] < horizon).any()]
