"""Host-loop cohort engine: Algorithms 1–4 over stacked client state,
with the protocol's control flow in Python and numpy.

Virtual time is quantized into ticks of dt = block / max(speed).  Each
tick every unblocked client earns ``speed * dt`` iterations of integer
fixed-point credit, and the whole population advances in one batched
block (``CohortLogRegTask.run_block``).  The per-client counters (round
``i``, offset ``h``, freshest-seen ``k``, credit) and the message
metadata live on the host as numpy; the ``[C, D]`` blocks ``w``/``U``
and the server model ``v`` live on the engine's device.

Ordering within a tick mirrors the event simulator:
  1. the server applies this tick's arrival bucket (pre-weighted, far
     tier + near ring), updates the H counts and fires a broadcast for
     every round that just completed;
  2. due broadcasts are ISRRECEIVE'd, freshest per client: w ← v̂ −
     eta_i · U where a client's freshest-seen k increases;
  3. the cohort advances: n_c = min(remaining, floor(credit)) masked
     iterations per client, wait-gated and unavailable clients excluded;
  4. finishing clients clip and noise their round update, their
     eta-weighted updates are bucket-summed by arrival tick, and they
     advance to the next round.

The ``[C, D]`` float work goes through the port's kernel wrappers with
the operands the device engine (``repro_torch.cohort.device``) gives
them — ``server_apply`` for the server's step (the apply, FedAsync's
decay, FedBuff's bank and flush), one launch a tick that has arrivals;
``tick_deliver`` for ISRRECEIVE; ``cohort_clip_noise``
(no weighted sum) for the round-completion DP; tick_scatter's rows pass
and finish (``tick_scatter_rows`` / ``tick_scatter_finish``) once per
completion tick for the near groups' sums, the far groups' sums (extra
weight rows beside the near ones) and the rows' settle — so on the card
the two engines run the same kernels on the same operands and agree bit
for bit, as they do on the CPU over the plain versions (the twins of
the kernels' add order).  Where the
reference's host engine (``repro/cohort/engine.py``) writes an
expression the device engine does not, this engine takes the device
engine's (see ``_apply_due`` and ``_finish_rounds``); against the
reference it agrees to float tolerance, its integers exactly.

With d = 1 broadcasts reach only blocked clients (U = 0, so ISRRECEIVE
is an exact model replacement), and with a ``sample_seed`` task the
trajectory matches the event simulator's to float summation order.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.salts import NOISE_SALT
from repro_torch.cohort.clients import ClientAxis
from repro_torch.cohort.state import (FRAC_BITS, BroadcastRing, CohortState,
                                      UpdateBuckets, default_max_ticks,
                                      next_pow2, pad_sizes, speed_accrual)
from repro_torch.core.strategies import get_strategy, ring_decay
from repro_torch.core.tasks import validate_dp_knobs
from repro_torch.kernels.cohort_dp import cohort_clip_noise
from repro_torch.kernels.tick_fused import (server_apply, tick_deliver,
                                            tick_scatter_finish)
from repro_torch.scenarios import ScenarioPlan, get_scenario
from repro_torch.telemetry import (STALE_BINS, SpanRecorder, build_report,
                                   open_trace, staleness_bin,
                                   update_msg_bytes)
from repro_torch.telemetry.costs import (OP_BLOCK_TICKS, OP_BUCKET_APPLIES,
                                         OP_CASCADE_TICKS, OP_COMPLETE_TICKS,
                                         OP_DELIVER_ROWS, OP_DELIVER_TICKS,
                                         OP_FAR_GROUPS, OP_FAR_TICKS,
                                         OP_RING_SCATTERS, OP_TICKS,
                                         zero_ops)

F32 = torch.float32


class CohortEngine:
    """The reference host engine's constructor vocabulary, on
    ``ctask.device``."""

    def __init__(self, ctask, *, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency_fn: Optional[Callable] = None, seed: int = 0,
                 block: int = 64, dp_sigma: float = 0.0,
                 dp_clip: float = 0.0, dp_round_clip: float = 0.0,
                 scenario=None, trace=None, dp_delta: float = 1e-5,
                 strategy=None):
        self.ctask = ctask
        self.device = dev = ctask.device
        C = self.C = ctask.C
        self.D = ctask.D
        self.d_gate = int(d)
        self.block = int(block)
        self.rng = np.random.default_rng(seed)
        # a Scenario (or preset name) drives latency, availability and —
        # when no speeds are given — the speed draw; an explicit
        # latency_fn keeps the legacy host-side numpy draw instead
        if scenario is not None and latency_fn is not None:
            raise ValueError("pass either scenario= or latency_fn=, "
                             "not both")
        scn = (get_scenario(scenario) if scenario is not None
               else None if latency_fn is not None
               else get_scenario("uniform"))
        if speeds is None and scn is not None:
            speeds = scn.speeds(C, seed)
        self.speeds = np.asarray(speeds if speeds is not None
                                 else np.ones(C), np.float64)
        if len(self.speeds) != C:
            raise ValueError(f"need {C} speeds, got {len(self.speeds)}")
        self.latency_fn = latency_fn or (lambda r: 0.05 + 0.05 * r.random())
        self.dt = self.block / float(self.speeds.max())
        self._plan = (ScenarioPlan(scn, C=C, seed=seed, dt=self.dt,
                                   device=dev) if scn is not None else None)
        self.accrual = speed_accrual(self.speeds, self.block)
        self.sizes = pad_sizes(sizes_per_client, C)
        self.etas = np.asarray(round_stepsizes, np.float64)
        # the device engine's static block length (masked steps past n
        # are no-ops), so both engines run the same SGD block
        self.b_stat = next_pow2(
            max(1, min(2 * self.block, int(self.sizes.max()))))

        validate_dp_knobs(dp_clip, dp_sigma, "CohortEngine")
        self.dp_sigma = float(dp_sigma)
        self.dp_clip = float(dp_clip)
        self.dp_round_clip = float(dp_round_clip)
        self.dp_on = self.dp_sigma > 0.0 or self.dp_round_clip > 0.0
        self.noise_scale = self.dp_clip * self.dp_sigma
        self._noise_base = prng.PRNGKey(seed ^ NOISE_SALT)      # CPU

        v0 = ctask.init_flat().to(F32)
        self.state = CohortState(
            w=v0[None, :].repeat(C, 1),
            U=torch.zeros((C, self.D), dtype=F32, device=dev), v=v0.clone(),
            i=np.zeros(C, np.int64), h=np.zeros(C, np.int64),
            k=np.zeros(C, np.int64), credit=np.zeros(C, np.int64))
        self.updates = UpdateBuckets()
        self.bcasts = BroadcastRing()

        # server strategy: the paper's apply on dequeue; FedAsync's
        # [R, D] sender-k buckets decayed at apply; FedBuff's buffer
        self.strategy = get_strategy(strategy)
        R = self.R = next_pow2(self.d_gate + 2)
        self._ones1 = torch.ones((1,), dtype=F32, device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        # the far bucket as server_apply's one overflow entry: due or not
        self._hit1 = torch.ones((1,), dtype=torch.bool, device=dev)
        self._miss1 = torch.zeros((1,), dtype=torch.bool, device=dev)
        self._zero_d = torch.zeros((self.D,), dtype=F32, device=dev)
        self._ar_R = torch.arange(R, dtype=torch.int64, device=dev)
        if self.strategy.stratified:
            self._dec_rows = torch.stack([
                ring_decay(self.strategy, s, R, device=dev)
                for s in range(R)])
            self._zero_rd = torch.zeros((R, self.D), dtype=F32, device=dev)
        if self.strategy.buffered:
            # written in place by server_apply: the engine's own tensor
            self._buf_vec = torch.zeros((self.D,), dtype=F32, device=dev)
            self._buf_cnt = 0
        far_vals = (self._plan.far_tick_values if self._plan is not None
                    else ())
        self._far_vals = {int(v): j for j, v in enumerate(far_vals)}
        self._far_tier = bool(far_vals)
        # the device engine's scatter route on one undivided client axis
        self._axis = ClientAxis(None, C)

        self.total_messages = 0
        self.total_broadcasts = 0
        self._h_counts: Dict[int, int] = {}     # Algorithm 3's H, per round
        self.upd_bytes = update_msg_bytes(self.D)
        self.part = np.zeros(C, dtype=np.int64)
        self.bytes_up = np.zeros(C, dtype=np.int64)
        self.stale_hist = np.zeros(STALE_BINS, dtype=np.int64)
        self.ovf_hwm = 0
        self.far_messages = 0
        self.ops = zero_ops()
        self.dp_delta = float(dp_delta)
        self._trace = open_trace(trace)
        self.history: List[Dict[str, float]] = []
        self._eta_i: Optional[np.ndarray] = None
        self._eta_dev: Optional[torch.Tensor] = None

    # -- host-side gathers --------------------------------------------------
    def _dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A copy of the host array on the engine's device."""
        return torch.tensor(a, dtype=dtype, device=self.device)

    def _eta(self) -> torch.Tensor:
        """f32 [C] round step sizes of the current rounds, on the device
        (copied again only after ``i`` changes)."""
        st = self.state
        if self._eta_i is None or not np.array_equal(self._eta_i, st.i):
            self._eta_i = st.i.copy()
            eta = self.etas[np.minimum(st.i, len(self.etas) - 1)]
            self._eta_dev = self._dev(eta.astype(np.float32))
        return self._eta_dev

    def _s_of(self, i: np.ndarray) -> np.ndarray:
        cols = np.minimum(i, self.sizes.shape[1] - 1)
        return self.sizes[np.arange(self.C), cols]

    def _latency_ticks(self, n: int) -> np.ndarray:
        """Legacy ``latency_fn`` path: one host draw per message."""
        lats = np.array([self.latency_fn(self.rng) for _ in range(n)])
        return np.maximum(1, np.ceil(lats / self.dt)).astype(np.int64)

    def _update_ticks(self, idx: np.ndarray, i: np.ndarray) -> np.ndarray:
        """Arrival-tick offsets of the finishing clients ``idx``."""
        if self._plan is not None:
            return self._plan.host_update_ticks(i)[idx]
        return self._latency_ticks(len(idx))

    def _bcast_ticks(self, k: int) -> np.ndarray:
        """Per-client arrival-tick offsets of broadcast ``k``."""
        if self._plan is not None:
            return self._plan.host_broadcast_ticks(k)
        return self._latency_ticks(self.C)

    def _avail(self, t: int) -> Optional[np.ndarray]:
        return self._plan.host_avail(t) if self._plan is not None else None

    # -- one tick -----------------------------------------------------------
    def step(self) -> None:
        st = self.state
        st.tick += 1
        t = st.tick
        self.ops[OP_TICKS] += 1

        # 1) server: apply this tick's arrival bucket, maybe broadcast
        far, near, pairs = self.updates.pop(t)
        if far is not None or near is not None:
            self.ops[OP_BUCKET_APPLIES] += 1
            self._apply_due(far, near, len(pairs))
        for r, _c, ks in pairs:
            self._h_counts[r] = self._h_counts.get(r, 0) + 1
            # staleness-at-apply against the pre-cascade server_k
            self.stale_hist[staleness_bin(st.server_k - ks)] += 1
        k_pre_cascade = st.server_k
        while self._h_counts.get(st.server_k, 0) >= self.C:
            del self._h_counts[st.server_k]
            st.server_k += 1
            self.total_broadcasts += 1
            self.bcasts.push(st.server_k, st.v,
                             t + self._bcast_ticks(st.server_k))
        if st.server_k > k_pre_cascade:
            self.ops[OP_CASCADE_TICKS] += 1

        # 2) deliver due broadcasts, freshest per client, in one
        # tick_deliver: each taking row becomes bc_v[best] - eta * U
        eta = self._eta()
        k_before = st.k.copy()
        due = self.bcasts.due(t)
        if due:
            best = np.zeros(self.C, np.int64)
            for j, b in enumerate(due):               # ascending k
                take = (b["at"] <= t) & (b["k"] > st.k)
                st.k[take] = b["k"]
                best[take] = j
            take = st.k > k_before
            if take.any():
                st.w = tick_deliver(st.w, st.U,
                                    torch.stack([b["v"] for b in due]),
                                    self._dev(best), self._dev(take), eta)
            self.bcasts.retire(t)
        deliver_rows = int(np.sum(st.k > k_before))
        self.ops[OP_DELIVER_ROWS] += deliver_rows
        if deliver_rows:
            self.ops[OP_DELIVER_TICKS] += 1

        # 3) advance the cohort: availability gates compute, credit
        # accrual and round completion
        active = ~st.blocked(self.d_gate)
        avail = self._avail(t)
        if avail is not None:
            active &= avail
        st.credit[active] += self.accrual[active]
        s_i = self._s_of(st.i)
        n = np.minimum(s_i - st.h, st.credit >> FRAC_BITS)
        n[~active] = 0
        np.maximum(n, 0, out=n)
        if int(n.max()) > 0:
            self.ops[OP_BLOCK_TICKS] += 1
            st.credit -= n << FRAC_BITS
            st.w, st.U = self.ctask.run_block(
                st.w, st.U, self._dev(st.i), self._dev(st.h), self._dev(n),
                eta, self.b_stat)
            st.h += n

        # 4) round completions: clip/noise, enqueue, advance round
        done = active & (st.h >= s_i)
        if done.any():
            self._finish_rounds(done, eta)

    def _apply_due(self, far, near, n_arrivals: int) -> None:
        """The server's apply of this tick's bucket: one ``server_apply``
        with the device engine's operands — the near bucket as the due
        slot and, with a far tier, the far bucket as the one overflow
        entry, each 0.0 where absent, so the sum is the device engine's
        ``(far + 0.0) + near`` (the reference's host engine adds only the
        parts present).  The buckets are popped already: nothing is reset
        but FedBuff's buffer."""
        st, strat, D = self.state, self.strategy, self.D
        A = self.R if strat.stratified else 1
        zero = self._zero_rd if strat.stratified else self._zero_d[None, :]
        kw = {}
        if self._far_tier:
            due = zero if near is None else near.reshape(A, D)
            kw.update(ovf=(zero if far is None else far.reshape(A, D))[None],
                      ovf_hit=self._miss1 if far is None else self._hit1)
        else:
            due = (near if near is not None else far).reshape(A, D)
        if strat.stratified:
            # FedAsync: decay each sender-k stratum by its staleness
            # against the pre-cascade server_k
            dec = self._dec_rows[st.server_k & (self.R - 1)]
        else:
            dec = self._ones1
        if strat.buffered:
            # FedBuff: bank this tick's arrivals, flush every B
            self._buf_cnt += n_arrivals
            flush = self._buf_cnt >= strat.buffer_size
            kw.update(buf=self._buf_vec,
                      flush=self._true if flush else self._false)
            if flush:
                self._buf_cnt = 0
        st.v = server_apply(st.v, due, dec, self._true, **kw)

    def _clip_noise(self, U, eta, done, t: int):
        """Round-completion DP of the finishing rows: the device
        engine's operand noise ``normal(fold_in(noise_base, t))``
        through ``cohort_clip_noise`` without its weighted sum."""
        noise = (prng.normal(prng.fold_in(self._noise_base, t),
                             (self.C, self.D), device=self.device)
                 if self.noise_scale > 0.0 else None)
        sent, _ = cohort_clip_noise(U, noise, eta * done.to(F32), done,
                                    clip=self.dp_round_clip,
                                    noise_scale=self.noise_scale,
                                    with_agg=False)
        return sent

    def _finish_rounds(self, done: np.ndarray, eta: torch.Tensor) -> None:
        st = self.state
        C, D, R = self.C, self.D, self.R
        strat = self.strategy
        idx = np.flatnonzero(done)
        self.ops[OP_COMPLETE_TICKS] += 1
        self.total_messages += len(idx)
        self.part[idx] += 1
        self.bytes_up[idx] += self.upd_bytes
        done_dev = self._dev(done)
        sent = (self._clip_noise(st.U, eta, done_dev, st.tick)
                if self.dp_on else st.U)

        arrive = np.full(C, -1, np.int64)
        arrive[idx] = st.tick + self._update_ticks(idx, st.i)
        ring = self._plan.ring_ticks if self._plan is not None else None
        # FedAsync buckets are stratified by the k each finishing client
        # stamps on its message: st.k, before the round advance below
        kmod = st.k & (R - 1)
        near, far = [], []
        for g in np.unique(arrive[idx]):
            g = int(g)
            in_g = arrive == g
            members = np.flatnonzero(in_g)
            pairs = [(int(st.i[c]), int(c), int(st.k[c])) for c in members]
            if ring is not None and g - st.tick >= ring:
                far.append((g, in_g, pairs))
                self.far_messages += len(members)
            else:
                near.append((g, in_g, pairs))
                self.ops[OP_RING_SCATTERS] += 1

        # near groups, far groups and the rows' settle: one rows pass and
        # one finish, a row per near group (per (group, stratum) under
        # FedAsync) weighted eta * in_g, each starting from its bucket
        # (0.0 when new) as the device engine's ring rows do, a single
        # all-false row when none; then the far groups' rows.  The
        # reference's host engine differs here in two expressions, and
        # this engine takes the device engine's: it asks the clip+noise
        # kernel for no weighted sum (no single-group ``vec = agg``), and
        # the DP settle is ``where(done, w + eta * (sent - U), w)``, which
        # keeps a row's bits (``w + where(done, ..., 0)`` turns -0.0 into
        # +0.0)
        if strat.stratified:
            zero = self._zero_rd
            masks = [in_g & (kmod == r) for _, in_g, _ in near
                     for r in range(R)]
        else:
            zero = self._zero_d[None, :]
            masks = [in_g for _, in_g, _ in near]
        rows = [self.updates.get(g) for g, _, _ in near]
        rows = [zero if r is None else r.reshape(-1, D) for r in rows]
        if not near:
            rows, masks = [zero[:1]], [np.zeros(C, bool)]
        masks = self._dev(np.stack(masks))
        wgt, any_g = eta[None, :] * masks.to(F32), masks.any(1)
        G = wgt.shape[0]
        if far:
            fw = self._far_weights(far, eta, kmod)
            wgt = torch.cat([wgt, fw])
            any_g = torch.cat([any_g, torch.ones(fw.shape[0],
                                                 dtype=torch.bool,
                                                 device=self.device)])
        st.w, st.U, partial, _ = self._axis.partials(
            sent, st.w, st.U, wgt, done_dev, eta, dp_on=self.dp_on)
        out = tick_scatter_finish(partial, torch.cat(rows), any_g)
        per = R if strat.stratified else 1
        for j, (g, _, pairs) in enumerate(near):
            vec = out[j * per:(j + 1) * per]
            self.updates.put(g, vec if strat.stratified else vec[0], pairs)

        if far:
            self._far_insert(far, out[G:], kmod)
            self.ops[OP_FAR_TICKS] += 1
            self.ops[OP_FAR_GROUPS] += len(far)
        # far-tier occupancy high-water mark (pending far arrival ticks)
        self.ovf_hwm = max(self.ovf_hwm, len(self.updates.far_contrib))

        st.i[done] += 1
        st.h[done] = 0
        st.credit[done] = np.minimum(st.credit[done],
                                     self.block << FRAC_BITS)

    def _far_weights(self, far, eta, kmod) -> torch.Tensor:
        """The far groups' scatter weight rows as the device engine takes
        them: ``eta_c`` on each group's clients, a row per far value of
        the plan (zero rows for absent values), ``[V * R, C]`` by sender-k
        stratum under FedAsync."""
        st, C = self.state, self.C
        grp = np.zeros((len(self._far_vals), C), bool)
        for g, in_g, _ in far:
            grp[self._far_vals[g - st.tick]] = in_g
        g_w = eta[None, :] * self._dev(grp).to(F32)                 # [V, C]
        if not self.strategy.stratified:
            return g_w
        oh_s = self._dev(kmod)[:, None] == self._ar_R                # [C, R]
        return (g_w[:, :, None] * oh_s[None].to(F32)).permute(
            0, 2, 1).reshape(-1, C)

    def _far_insert(self, far, vecs, kmod) -> None:
        """Each far group's weighted sum (``vecs``: the scatter's far rows)
        added to its bucket (0.0 when new); under FedAsync per sender-k
        stratum, an empty stratum untouched."""
        st, R = self.state, self.R
        if self.strategy.stratified:
            vecs = vecs.reshape(-1, R, self.D)
        for g, in_g, pairs in far:
            vec = vecs[self._far_vals[g - st.tick]]
            cur = self.updates.get(g, far=True)
            if self.strategy.stratified:
                cur = self._zero_rd if cur is None else cur
                any_r = self._dev(np.array([(in_g & (kmod == r)).any()
                                            for r in range(R)]))
                vec = torch.where(any_r[:, None], cur + vec, cur)
            else:
                vec = (self._zero_d if cur is None else cur) + vec
            self.updates.put(g, vec, pairs, far=True)

    # -- main loop ----------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, *, max_rounds: int, eval_every: int = 1,
            eval_fn: Optional[Callable] = None,
            max_ticks: Optional[int] = None) -> Dict[str, Any]:
        """Run until the server completes ``max_rounds`` broadcasts; the
        reference's result schema.  Wall phases as the device engine's:
        ``first_segment`` / ``steady`` / ``eval``, each segment closed by
        a device sync.  (torch has no transfer guard: the reference's
        check that steady ticks make no implicit host-to-device copy
        has no counterpart here.)"""
        if eval_fn is not None:
            evals = lambda vec: eval_fn(self.ctask.unflatten(vec))  # noqa: E731
        else:
            evals = self.ctask.metrics
        st = self.state
        if max_ticks is None:
            plan = self._plan
            max_ticks = default_max_ticks(
                self.sizes, self.speeds, self.block, max_rounds,
                lat_tail_ticks=plan.max_lat_ticks if plan is not None else 1,
                duty=plan.duty if plan is not None else 1.0)
        next_eval = eval_every
        timer = self.timer = SpanRecorder()
        run_t0 = time.perf_counter()
        first = True
        seg_t0 = run_t0
        while st.server_k < max_rounds:
            if st.tick >= max_ticks:
                raise RuntimeError(
                    f"cohort engine stalled: {st.tick} ticks, "
                    f"server_k={st.server_k} < {max_rounds} "
                    f"(in flight: {len(self.updates)} updates, "
                    f"{len(self.bcasts.pending)} broadcasts)")
            self.step()
            if st.server_k >= next_eval:
                self._sync()
                timer.add("first_segment" if first else "steady",
                          time.perf_counter() - seg_t0)
                with timer.phase("eval"):
                    m = evals(st.v)
                    m.update(round=st.server_k, time=st.tick * self.dt,
                             messages=self.total_messages)
                    self.history.append(m)
                    next_eval = st.server_k + eval_every
                    self._emit_segment()
                first = False
                seg_t0 = time.perf_counter()
        self._sync()
        timer.add("first_segment" if first else "steady",
                  time.perf_counter() - seg_t0)
        with timer.phase("eval"):
            final = evals(st.v)
        final.update(round=st.server_k, time=st.tick * self.dt,
                     messages=self.total_messages,
                     broadcasts=self.total_broadcasts,
                     overflow_hwm=self.ovf_hwm,
                     far_messages=self.far_messages)
        timer.add("run", time.perf_counter() - run_t0)
        report = self.telemetry_report(wall=timer.as_dict())
        if self._trace:
            self._trace.emit("report", **report.to_dict())
            self._trace.close()
        return {"final": final, "history": self.history,
                "model": self.ctask.unflatten(st.v), "telemetry": report}

    # -- telemetry ----------------------------------------------------------
    def _emit_segment(self) -> None:
        if not self._trace:
            return
        st = self.state
        self._trace.emit(
            "segment", engine="host", round=int(st.server_k),
            tick=int(st.tick), time=int(st.tick) * self.dt,
            messages=self.total_messages,
            broadcasts=self.total_broadcasts,
            bytes_up_total=int(self.bytes_up.sum()),
            staleness_hist=self.stale_hist,
            overflow_hwm=self.ovf_hwm, ops=self.ops.copy())

    def telemetry_report(self, wall=None):
        """MetricsReport from the counters accumulated so far."""
        st = self.state
        src_task = self.ctask.task
        return build_report(
            engine="host", clients=self.C, flat_dim=self.D,
            rounds=int(st.server_k), messages=self.total_messages,
            broadcasts=self.total_broadcasts,
            participation=self.part, bytes_up=self.bytes_up,
            staleness_hist=self.stale_hist,
            overflow_hwm=self.ovf_hwm, far_messages=self.far_messages,
            ticks=int(st.tick), ops=self.ops,
            dp_sigma=self.dp_sigma, dp_delta=self.dp_delta,
            n_examples=(int(src_task.X.shape[0])
                        if hasattr(src_task, "X") else None),
            sizes_per_client=self.sizes, wall=wall)
