"""Discrete-event asynchronous-network simulator for the FL protocol (the
reference's ``repro/core/simulator.py``).

Simulates the paper's deployment regime on virtual time:
  * heterogeneous client compute speeds (iterations / second),
  * message latencies drawn per message (out-of-order delivery arises
    naturally: a later-sent message may arrive earlier),
  * clients compute *lazily* between events, so a mid-round broadcast
    arrival replaces the local model exactly at the iteration it would
    have in a real deployment (ISRRECEIVE semantics),
  * the wait gate blocks a client that runs d rounds ahead (Supp. B.2).

With a ``Scenario`` (``scenario=`` instead of ``latency_fn=``) latency
comes from the message-addressed chain the cohort engines use — the
update of client c's round i and broadcast k's delivery to client c land
in the same latency-table bin in every engine, here in continuous
seconds — and availability from the model's continuous-time windows
(diurnal windows exactly, renewal churn as the true alternating renewal
process on the cohort tick mask's draws).  Epoch-hash churn (``Churn``,
``RegionalChurn``) has no continuous form and is rejected.

The scheduling (the event heap, the scenario draws, the windows) runs on
the host; every client's model and round update are params dicts of
tensors on ``device`` (the card unless the caller asks for the CPU), one
small group of launches per SGD step.  The simulator is the test harness
for Theorem 1's consistency invariant (``record_invariant``) and the
measurement rig for rounds and communication.
"""
from __future__ import annotations

import heapq
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import prng
from repro_torch.core.protocol import Client, Server
from repro_torch.devices import resolve_device
from repro_torch.telemetry import (STALE_BINS, SpanRecorder,
                                   broadcast_msg_bytes, build_report,
                                   model_flat_dim, open_trace, staleness_bin,
                                   update_msg_bytes)
from repro_torch.tree import tree_map


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)  # round_complete | update_arrival | ...
    payload: Any = field(compare=False)
    client_id: int = field(compare=False, default=-1)


class AsyncFLSimulator:
    def __init__(self, task, *, n_clients: int, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency_fn: Optional[Callable[[np.random.Generator], float]]
                 = None,
                 seed: int = 0, record_invariant: bool = False,
                 global_sizes: Optional[Sequence[int]] = None,
                 scenario=None, trace=None, dp_delta: float = 1e-5,
                 strategy=None, device=None):
        self.task = task
        self.device = resolve_device(device)
        self.n = n_clients
        self.rng = np.random.default_rng(seed)
        self._plan = self._windows = None
        if scenario is not None:
            if latency_fn is not None:
                raise ValueError("pass either scenario= or latency_fn=, "
                                 "not both")
            from repro_torch.scenarios import get_scenario, scenario_plan
            scn = get_scenario(scenario)
            # windows() raises for availability models with no
            # continuous-time form (epoch-hash churn)
            self._windows = scn.availability.windows(n_clients, seed)
            self._plan = scenario_plan(scn, C=n_clients, seed=seed)
            if speeds is None:
                speeds = scn.speeds(n_clients, seed)
        self.speeds = list(speeds) if speeds is not None else [1.0] * n_clients
        self.latency_fn = latency_fn or (lambda r: 0.05 + 0.05 * r.random())
        self.record_invariant = record_invariant
        self.global_sizes = global_sizes

        w0 = task.init_model(device=self.device)
        self.server = Server(w0, n_clients, round_stepsizes,
                             strategy=strategy)
        if isinstance(sizes_per_client[0], (list, tuple)):
            per_client = sizes_per_client
        else:
            per_client = [list(sizes_per_client)] * n_clients
        self._sizes_sched = [list(s) for s in per_client]
        self.clients = [
            Client(c, w0, task, per_client[c], round_stepsizes, d,
                   seed=seed * 1000 + c)
            for c in range(n_clients)
        ]
        self.now = 0.0
        self._seq = itertools.count()
        self.events: List[_Event] = []
        self.last_advance = [0.0] * n_clients
        self.total_messages = 0
        self.total_broadcasts = 0
        # telemetry: communication census + staleness-at-apply counters
        self.flat_dim = model_flat_dim(w0)
        self._upd_bytes = update_msg_bytes(self.flat_dim)
        self._bc_bytes = broadcast_msg_bytes(self.flat_dim)
        self.part = np.zeros(n_clients, dtype=np.int64)
        self.bytes_up = np.zeros(n_clients, dtype=np.int64)
        self.stale_hist = np.zeros(STALE_BINS, dtype=np.int64)
        self.dp_delta = dp_delta
        self._trace = open_trace(trace)
        self.history: List[Dict[str, float]] = []
        self.invariant_violations: List[Tuple[int, int, int]] = []
        for c in range(n_clients):
            self._schedule_round_complete(c)

    # -- scheduling helpers -------------------------------------------------
    def _push(self, t: float, kind: str, payload, client_id: int = -1):
        heapq.heappush(self.events,
                       _Event(t, next(self._seq), kind, payload, client_id))

    def _schedule_round_complete(self, c: int) -> None:
        cl = self.clients[c]
        if cl.blocked:
            return
        work_s = cl.remaining_in_round() / self.speeds[c]
        if self._windows is not None:
            t_done = self._windows.advance(c, self.now, work_s)
        else:
            t_done = self.now + work_s
        self._push(t_done, "round_complete", None, c)

    def _advance_client(self, c: int, t: float) -> None:
        """Lazily run client c's iterations up to virtual time t (only
        its availability-window on-time counts as compute)."""
        cl = self.clients[c]
        if self._windows is not None:
            dt = self._windows.on_time(c, self.last_advance[c], t)
        else:
            dt = t - self.last_advance[c]
        self.last_advance[c] = t
        if cl.blocked or dt <= 0:
            return
        n = min(cl.remaining_in_round(), int(math.floor(dt * self.speeds[c])))
        if n > 0:
            if self.record_invariant and self.global_sizes is not None:
                cl.record_delay(self.global_sizes)
            cl.run(n)

    # -- event handlers -------------------------------------------------------
    def _on_round_complete(self, ev: _Event) -> None:
        c = ev.client_id
        cl = self.clients[c]
        self._advance_client(c, ev.time)
        rem = cl.remaining_in_round()
        if cl.blocked:
            return
        if rem > 0:                       # rounding drift: finish exactly
            cl.run(rem)
        msg = cl.finish_round()
        self.total_messages += 1
        self.part[c] += 1
        self.bytes_up[c] += self._upd_bytes
        if self._plan is not None:
            # one draw per round for the whole fleet, cached in the plan
            lat = float(self._plan.update_latencies_s(msg.round_idx)[c])
        else:
            lat = self.latency_fn(self.rng)
        if self._trace:
            self._trace.emit("update_sent", time=ev.time, client=c,
                             round=msg.round_idx, k_send=msg.k_send,
                             bytes=self._upd_bytes, latency_s=lat)
        self._push(ev.time + lat, "update_arrival", msg)
        self._schedule_round_complete(c)   # may be a no-op if now blocked

    def _on_update_arrival(self, ev: _Event) -> None:
        msg = ev.payload
        # staleness-at-apply: completed server rounds since the sender's
        # freshest-seen broadcast (bounded by d-1 via the wait gate)
        tau = self.server.k - msg.k_send
        self.stale_hist[staleness_bin(tau)] += 1
        if self._trace:
            self._trace.emit("update_applied", time=ev.time,
                             client=msg.client_id, round=msg.round_idx,
                             server_k=self.server.k, staleness=tau)
        for bcast in self.server.receive(msg):
            self.total_broadcasts += 1
            if self._plan is not None:
                lats = self._plan.broadcast_latencies_s(bcast.k)
            else:
                lats = [self.latency_fn(self.rng) for _ in range(self.n)]
            if self._trace:
                self._trace.emit("broadcast_fired", time=ev.time, k=bcast.k,
                                 bytes_per_client=self._bc_bytes,
                                 clients=self.n)
            for c in range(self.n):
                self._push(ev.time + float(lats[c]), "broadcast_arrival",
                           bcast, c)

    def _on_broadcast_arrival(self, ev: _Event) -> None:
        c = ev.client_id
        cl = self.clients[c]
        was_blocked = cl.blocked
        self._advance_client(c, ev.time)
        if self._trace:
            self._trace.emit("broadcast_applied", time=ev.time, client=c,
                             k=ev.payload.k, accepted=ev.payload.k > cl.k)
        cl.isr_receive(ev.payload)
        if was_blocked and not cl.blocked:
            self.last_advance[c] = ev.time
            self._schedule_round_complete(c)

    # -- main loop ------------------------------------------------------------
    def run(self, *, max_rounds: int, eval_every: int = 1,
            eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None
            ) -> Dict[str, Any]:
        """Run until the server has completed ``max_rounds`` broadcasts."""
        evals = eval_fn or (lambda w: self.task.metrics(w))
        next_eval = eval_every
        timer = self.timer = SpanRecorder()
        run_t0 = time.perf_counter()
        while self.events and self.server.k < max_rounds:
            ev = heapq.heappop(self.events)
            self.now = ev.time
            if ev.kind == "round_complete":
                self._on_round_complete(ev)
            elif ev.kind == "update_arrival":
                self._on_update_arrival(ev)
            elif ev.kind == "broadcast_arrival":
                self._on_broadcast_arrival(ev)
            if self.server.k >= next_eval:
                with timer.phase("eval"):
                    m = evals(self.server.v)
                m.update(round=self.server.k, time=self.now,
                         messages=self.total_messages)
                self.history.append(m)
                next_eval = self.server.k + eval_every
        with timer.phase("eval"):
            final = evals(self.server.v)
        final.update(round=self.server.k, time=self.now,
                     messages=self.total_messages,
                     broadcasts=self.total_broadcasts)
        timer.add("run", time.perf_counter() - run_t0)
        report = self.telemetry_report(wall=timer.as_dict())
        if self._trace:
            self._trace.emit("report", **report.to_dict())
            self._trace.close()
        return {"final": final, "history": self.history,
                "model": self.server.v, "telemetry": report}

    def telemetry_report(self, wall=None):
        """MetricsReport from the counters accumulated so far."""
        return build_report(
            engine="event", clients=self.n, flat_dim=self.flat_dim,
            rounds=self.server.k, messages=self.total_messages,
            broadcasts=self.total_broadcasts,
            participation=self.part, bytes_up=self.bytes_up,
            staleness_hist=self.stale_hist, virtual_time=self.now,
            dp_sigma=float(getattr(self.task, "dp_sigma", 0.0) or 0.0),
            dp_delta=self.dp_delta,
            n_examples=(int(self.task.X.shape[0])
                        if hasattr(self.task, "X") else None),
            sizes_per_client=self._sizes_sched, wall=wall)


def run_sync_baseline(task, *, n_clients: int, n_rounds: int,
                      sample_size: int, eta: float, seed: int = 0,
                      device=None) -> Dict[str, Any]:
    """Original synchronous FL (constant step + sample size) baseline."""
    dev = resolve_device(device)
    w = task.init_model(device=dev)
    history = []
    key = prng.PRNGKey(seed)
    for r in range(n_rounds):
        updates = []
        for c in range(n_clients):
            key, sub = prng.split(key)
            _, U = task.run_iterations(
                w, task.zero_update(device=dev), round_idx=r, client_id=c,
                start_h=0, n_iters=sample_size, eta=eta, rng=sub)
            updates.append(U)
        total = updates[0]
        for U in updates[1:]:
            total = tree_map(lambda a, b: a + b, total, U)
        w = tree_map(lambda p, u: p - eta * u, w, total)
        m = task.metrics(w)
        m["round"] = r + 1
        history.append(m)
    return {"final": history[-1], "history": history, "model": w}
