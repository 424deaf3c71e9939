"""Device-resident cohort engine: the paper's protocol (Algorithms 1-4)
with the whole state on the card.

``DeviceCohortState`` — the ``[C, D]`` population blocks, per-client
counters, message rings, the overflow bucket, the strategy buffers and
the telemetry counters — lives on the engine's device for the whole run.
One protocol tick is two phases:

1. **Integer phase.**  The protocol's integer state (rounds ``i``,
   offsets ``h``, freshest-seen ``k``, fixed-point ``credit``, the H-count
   and broadcast rings, the overflow bucket's ticks and counts, the
   census counters) never depends on a float value, so the whole tick's
   integer update runs first, as tensor ops on the device: bucket and
   overflow pop counts, the broadcast cascade (unrolled ``R`` masked
   steps — it can fire at most ``R`` times, each zeroing a distinct H
   slot — with each broadcast's own latency draw), ISRRECEIVE's
   freshest-broadcast pick, availability, credit accrual, round
   completion, the far-tier slot plan, and, with ``fuse_ticks``, the
   next tick's block preview.  The branch predicates and the overflow
   error latch are packed into one small tensor and read by the host:
   **one host sync per tick**.
2. **Float phase.**  The host enqueues only the ``[C, D]`` work the
   predicates call for — the fused kernels of ``repro_torch.kernels``
   (``server_apply`` every tick: the server's whole step in one launch,
   its flags read on the device, the ring slot, the due overflow row,
   FedBuff's buffer and the fired broadcast rows written in place;
   ``tick_deliver`` on delivery
   ticks; the SGD block on block ticks; ``cohort_clip_noise`` or
   ``cohort_clip_noise_prng`` + ``tick_scatter`` on completion ticks;
   the far-tier group sums on ticks that route updates past the ring)
   — and moves on to the next tick's integer phase while the card works.

Host-known scalars (the tick number, the pre-tick ``server_k``) index
the rings and key the draws directly, and the constants of the tick are
device tensors built once, so a tick makes no host-to-device copy.

The op census and the ``fuse_ticks`` iteration census are exact against
the reference (``repro/cohort/device.py``): a loop iteration is one tick
plus, when the int-only preview says the next tick runs no block, that
next tick.  Strategies: the paper's, FedAsync (sender-k stratified
``[L, R, D]`` buckets decayed at apply) and FedBuff (a banked buffer
flushed every ``buffer_size`` arrivals).  DP noise: ``operand`` (the
reference's threefry normals, drawn by torch ops) or ``in_kernel``
(counter-based normals generated inside the CUDA kernel).

Over a ``clients`` mesh (``mesh=``, a 1-D ``DeviceMesh`` from
``repro_torch.sharding.cohort_mesh``) each rank holds its rows of the
``[C, ...]`` fields (``cohort_shardings``: ``Shard(0)``, ``bc_at``
``Shard(1)``) and a copy of the rest, and runs the tick on its local
rows with the collectives of ``cohort/clients.py`` made explicitly: one
int32 all-reduce of the tick's cross-client counts before the host
read, and on completion ticks the ring and far sums' block partials
under the global partition (a straddling block's running sum passed to
the next rank) in one all-gather with the ring counts.  The result is
the one-device engine's, bit for bit, at every world size; ``state``
shows the fields as DTensors on the mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.salts import NOISE_SALT
from repro_torch.cohort.clients import ClientAxis
from repro_torch.cohort.state import (FRAC_BITS, DeviceCohortState,
                                      default_max_ticks, dtensor_views,
                                      next_pow2, pad_sizes, speed_accrual)
from repro_torch.core.strategies import get_strategy, ring_decay
from repro_torch.core.tasks import validate_dp_knobs
from repro_torch.devices import resolve_device
from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                           cohort_clip_noise_prng)
from repro_torch.kernels.tick_fused import (server_apply, tick_deliver,
                                            tick_scatter_finish)
from repro_torch.scenarios import (ScenarioPlan, get_scenario,
                                   legacy_latency_scenario)
from repro_torch.telemetry import (STALE_BINS, SpanRecorder, build_report,
                                   maybe_span, open_trace, update_msg_bytes)
from repro_torch.telemetry.costs import (N_OPS, OP_FAR_GROUPS, OP_FAR_TICKS,
                                         OP_RING_SCATTERS)

I32 = torch.int32
F32 = torch.float32

# Bound on the distinct far arrival ticks one completion tick inserts
# into the overflow bucket (the reference's unroll bound): a tick that
# produces more trips the err latch and run() raises with the ring_cap
# advice.
FAR_UNROLL_CAP = 16


class TickPreds(NamedTuple):
    """The per-tick host read: what the float phase must run."""
    cascades: int
    deliver_rows: int
    any_block: int
    any_done: int
    next_no_block: int      # fuse preview: the next tick runs no block
    any_far: int            # a finished update routes past the ring
    err: int                # the overflow bucket's error latch


class _FarPlan(NamedTuple):
    """The far tier's integer plan of one completion tick, by far tick
    value (the plan's ``far_tick_values``, ascending)."""
    grp: torch.Tensor       # [V, C] bool: finished clients per far value
    slot_of_q: torch.Tensor  # [Q] int64: the group each written slot takes
    written_q: torch.Tensor  # [Q] bool: slots written this tick
    any_r: torch.Tensor     # [V, R] bool: a group's sender-k strata used


class DeviceCohortEngine:
    """The reference engine's constructor vocabulary, on ``ctask.device``."""

    def __init__(self, ctask, *, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency=None, seed: int = 0, block: int = 64,
                 dp_sigma: float = 0.0, dp_clip: float = 0.0,
                 dp_round_clip: float = 0.0, scenario=None, trace=None,
                 dp_delta: float = 1e-5, strategy=None,
                 dp_rng: str = "operand", fuse_ticks: bool = True,
                 mesh=None):
        self.ctask = ctask
        self.device = dev = ctask.device
        C = self.C = ctask.C
        # this rank's clients [lo, hi): all of them without a mesh or
        # where C does not divide over the ranks (every rank then runs
        # the whole population, as the reference does)
        self.mesh = mesh
        self.axis = axis = ClientAxis(mesh, C)
        lo, hi = axis.lo, axis.hi
        if axis.sharded and not hasattr(ctask, "for_clients"):
            raise TypeError(f"{type(ctask).__name__} has no for_clients: "
                            f"it cannot run on a cut client axis")
        self.ltask = ctask.for_clients(lo, hi) if axis.sharded else ctask
        self.D = ctask.D
        self.d_gate = int(d)
        self.block = int(block)
        if (2 * self.block) << FRAC_BITS >= 2 ** 31:
            raise ValueError(
                f"block={block} overflows the engine's int32 fixed-point "
                f"credit (max {(2 ** 30 >> FRAC_BITS) - 1})")
        self.seed = int(seed)
        if scenario is not None and latency is not None:
            raise ValueError("pass either scenario= or latency=, not both")
        scn = (get_scenario(scenario) if scenario is not None
               else legacy_latency_scenario(latency))
        if speeds is None:
            speeds = scn.speeds(C, seed)
        self.speeds = np.asarray(speeds if speeds is not None
                                 else np.ones(C), np.float64)
        if len(self.speeds) != C:
            raise ValueError(f"need {C} speeds, got {len(self.speeds)}")
        self.dt = self.block / float(self.speeds.max())
        self._plan = ScenarioPlan(scn, C=C, seed=self.seed, dt=self.dt,
                                  device=dev)
        self._lplan = self._plan.for_clients(lo, hi)
        self.sizes = pad_sizes(sizes_per_client, C)
        self.etas = np.asarray(round_stepsizes, np.float64)

        validate_dp_knobs(dp_clip, dp_sigma, "DeviceCohortEngine")
        self.dp_sigma = float(dp_sigma)
        self.dp_clip = float(dp_clip)
        self.dp_round_clip = float(dp_round_clip)
        if dp_rng not in ("operand", "in_kernel"):
            raise ValueError(f"dp_rng={dp_rng!r} not in "
                             f"('operand', 'in_kernel')")
        self.dp_rng = dp_rng
        self.dp_on = self.dp_sigma > 0.0 or self.dp_round_clip > 0.0
        self.noise_scale = self.dp_clip * self.dp_sigma
        self.fuse_ticks = bool(fuse_ticks)
        self.dp_delta = float(dp_delta)
        self._trace_on = trace is not None
        self._trace = open_trace(trace, axis.rank)

        # ring capacities: L covers latency offsets up to the plan's ring
        # boundary (Scenario.ring_cap); offsets past it go to the Q-slot
        # overflow bucket.  F bounds the distinct far arrival ticks one
        # completion tick inserts (capped at FAR_UNROLL_CAP).
        self.L = self._plan.ring_ticks
        far_vals = self._plan.far_tick_values
        self.F = min(len(far_vals), FAR_UNROLL_CAP)
        self.Q = (next_pow2(min(C * (self.d_gate + 1),
                                self._plan.max_lat_ticks + 1, 128))
                  if self.F else 1)
        self.R = next_pow2(self.d_gate + 2)
        self.B = next_pow2(self.d_gate + 2)
        self.strategy = get_strategy(strategy)
        self.b_stat = next_pow2(
            max(1, min(2 * self.block, int(self.sizes.max()))))

        # constants of the tick, built once on the device
        R, L = self.R, self.L
        self._etas_dev = torch.tensor(self.etas, dtype=F32, device=dev)
        self._sizes_dev = torch.tensor(self.sizes[lo:hi], dtype=I32,
                                       device=dev)
        self._accrual_dev = torch.tensor(
            speed_accrual(self.speeds, self.block)[lo:hi], dtype=I32,
            device=dev)
        tau = (np.arange(R)[:, None] - np.arange(R)[None, :]) & (R - 1)
        self._tau_bins = torch.tensor(np.minimum(tau, STALE_BINS - 1),
                                      dtype=torch.int64, device=dev)
        self._ar_L = torch.arange(L, dtype=I32, device=dev)
        self._ar_R = torch.arange(R, dtype=I32, device=dev)
        self._ar_Q = torch.arange(self.Q, dtype=torch.int64, device=dev)
        self._far_vals = torch.tensor(far_vals, dtype=I32, device=dev)
        self._ones1 = torch.ones((1,), dtype=F32, device=dev)
        self._far_on = torch.ones((len(far_vals) * (R if self.strategy
                                                     .stratified else 1),),
                                  dtype=torch.bool, device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        self._iter_inc = torch.tensor([[1, 0], [1, 1]], dtype=I32,
                                      device=dev)
        self._tick_one = torch.ones((), dtype=I32, device=dev)
        self._tick_zero = torch.zeros((), dtype=I32, device=dev)
        # FedAsync: the [R] decay row depends on server_k mod R only
        self._dec_rows = torch.stack([
            ring_decay(self.strategy, s, R, device=dev) for s in range(R)])
        self._noise_base = prng.PRNGKey(self.seed ^ NOISE_SALT)   # CPU
        self.upd_bytes = update_msg_bytes(self.D)
        # update-latency offsets of the current rounds, kept while st.i is
        # the same tensor (a tick without completions keeps it)
        self._off_i: Optional[torch.Tensor] = None
        self._off: Optional[torch.Tensor] = None
        #: host reads made by the tick loop: one per tick, one per segment
        self.host_syncs = {"tick": 0, "segment": 0}
        #: collectives made over the mesh, by kind (``ClientAxis``)
        self.collectives = axis.collectives
        self._spans: Optional[SpanRecorder] = None
        self._st = self._init_state()
        self.history: List[Dict[str, float]] = []

    # -- the state: local rows, or DTensor views over the mesh -------------
    @property
    def state(self) -> DeviceCohortState:
        """The state; over a mesh, every field a DTensor view of this
        rank's tensor (no copy), placed as ``cohort_shardings`` says."""
        if self.mesh is None:
            return self._st
        return dtensor_views(self._st, self.mesh, self.C)

    @state.setter
    def state(self, st: DeviceCohortState) -> None:
        self._st = DeviceCohortState(*(
            t.to_local() if hasattr(t, "to_local") else t for t in st))

    @property
    def local_state(self) -> DeviceCohortState:
        """This rank's tensors (the whole state without a mesh)."""
        return self._st

    # -- tracing -------------------------------------------------------------
    @property
    def spans(self) -> Optional[SpanRecorder]:
        """The recorder of the segment loop's spans, counters and kernel
        launches; None (the default) records nothing.

        Spans (``segment`` a call; ``tick`` a tick, args ``t`` and
        ``fused``; under it ``tick.integer``, ``tick.read``,
        ``server_step``, ``deliver``, ``client_block``, ``clip_noise``
        with ``noise_draw`` and ``clip_noise_kernel``, ``ring_scatter``)
        and the caching allocator's counters over ``tick``,
        ``client_block`` and ``clip_noise``.  Handed to the client axis
        and, where it takes one, to the task (``spans``)."""
        return self._spans

    @spans.setter
    def spans(self, rec: Optional[SpanRecorder]) -> None:
        self._spans = self.axis.spans = rec
        if hasattr(self.ltask, "spans"):
            self.ltask.spans = rec

    def _init_state(self) -> DeviceCohortState:
        C, D, L, R, B, Q = self.axis.n, self.D, self.L, self.R, self.B, self.Q
        dev = self.device
        v0 = self.ctask.init_flat().to(F32)
        strat = self.strategy

        def z(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return DeviceCohortState(
            w=v0[None, :].repeat(C, 1), U=z(C, D, dtype=F32), v=v0.clone(),
            i=z(C), h=z(C), k=z(C), credit=z(C), server_k=z(), tick=z(),
            upd_vec=z(L, D, dtype=F32), upd_cnt=z(L, R), h_counts=z(R),
            bc_v=z(B, D, dtype=F32), bc_k=z(B), bc_at=z(B, C),
            ovf_vec=z(Q, D, dtype=F32), ovf_at=z(Q), ovf_cnt=z(Q, R),
            err=z(), messages=z(), broadcasts=z(), part=z(C),
            bytes_up=z(C), stale_hist=z(STALE_BINS), upd_ks=z(L, R),
            ovf_ks=z(Q, R), ovf_hwm=z(), far_msgs=z(),
            # strategy buffers: full size only when the strategy uses them
            upd_kvec=z(*((L, R, D) if strat.stratified else (1, 1, 1)),
                       dtype=F32),
            ovf_kvec=z(*((Q, R, D) if strat.stratified else (1, 1, 1)),
                       dtype=F32),
            buf_vec=z(D if strat.buffered else 1, dtype=F32), buf_cnt=z(),
            ops=z(N_OPS), iters=z(2))

    def _update_offsets(self, i: torch.Tensor) -> torch.Tensor:
        """``plan.update_ticks(i)``, drawn once per distinct ``i`` tensor."""
        if self._off_i is not i:
            self._off = self._lplan.update_ticks(i)
            self._off_i = i
        return self._off

    # -- one protocol tick --------------------------------------------------
    def _tick(self, st: DeviceCohortState, t: int, sk0: int):
        """Advance ``st`` by tick ``t`` (= st.tick + 1); ``sk0`` is the
        pre-tick ``server_k``.  Returns the new state and the predicates.
        Over a cut client axis ``st`` holds this rank's rows: the counts
        across clients are summed over the ranks before the host read."""
        C, L, R, B, Q = self.C, self.L, self.R, self.B, self.Q
        d_gate, block = self.d_gate, self.block
        sizes, accrual = self._sizes_dev, self._accrual_dev
        i_cap = sizes.shape[1] - 1
        strat, plan, axis = self.strategy, self._lplan, self.axis
        far_tier = self.F > 0
        rec = self._spans
        # the integer phase runs from here to the packed read: its span is
        # entered and left by hand
        integer = maybe_span(rec, "tick.integer")
        integer.__enter__()

        # ---- 1) integer phase ------------------------------------------
        # server: pop this tick's arrival slot and any overflow entry due
        # now (entries merge by arrival tick, so at most one is due)
        slot = t & (L - 1)
        cnt_total = st.upd_cnt[slot]
        ks_total = st.upd_ks[slot]
        ovf_at, ovf_cnt, ovf_ks = st.ovf_at, st.ovf_cnt, st.ovf_ks
        if far_tier:
            ovf_hit = st.ovf_at == t                                 # [Q]
            hit_i = ovf_hit.to(I32)[:, None]
            cnt_total = cnt_total + (st.ovf_cnt * hit_i).sum(0, dtype=I32)
            ks_total = ks_total + (st.ovf_ks * hit_i).sum(0, dtype=I32)
            ovf_at = torch.where(ovf_hit, 0, st.ovf_at)
            ovf_cnt = torch.where(ovf_hit[:, None], 0, st.ovf_cnt)
            ovf_ks = torch.where(ovf_hit[:, None], 0, st.ovf_ks)
        n_arr = cnt_total.sum(dtype=I32)
        has_arr = n_arr > 0
        upd_cnt = st.upd_cnt.clone()
        upd_cnt[slot] = 0
        upd_ks = st.upd_ks.clone()
        upd_ks[slot] = 0
        h_counts = st.h_counts + cnt_total
        # staleness-at-apply: slot r of ks_total counts arrivals sent
        # against k = r (mod R), tau = (server_k - r) mod R (pre-cascade)
        stale_hist = st.stale_hist.index_add(
            0, self._tau_bins[sk0 & (R - 1)], ks_total)
        buf_cnt = st.buf_cnt
        flush = None
        if strat.buffered:
            # FedBuff: bank the due bucket, flush on every BUF-th message;
            # the kernel reads the flush flag on the device
            buf_cnt = buf_cnt + n_arr
            flush = buf_cnt >= strat.buffer_size
            buf_cnt = torch.where(flush, 0, buf_cnt)

        # broadcast cascade: fire while round server_k's H slot is full;
        # broadcast k = sk0 + r + 1 arrives after its own latency draw
        hc = h_counts.clone()
        bc_k = st.bc_k.clone()
        bc_at = st.bc_at.clone()
        fired = torch.zeros((B,), dtype=torch.bool, device=self.device)
        go = self._true
        for r in range(R):
            idx = (sk0 + r) & (R - 1)
            go = go & (hc[idx] >= C)
            hc[idx] = torch.where(go, 0, hc[idx])
            b = (sk0 + r + 1) & (B - 1)
            bc_k[b] = torch.where(go, sk0 + r + 1, bc_k[b])
            bc_at[b] = torch.where(
                go, t + plan.broadcast_ticks(sk0 + r + 1), bc_at[b])
            fired[b] = fired[b] | go
        ncasc = fired.sum(dtype=I32)

        # masked ISRRECEIVE: freshest due broadcast per client
        elig = (bc_at <= t) & (bc_k[:, None] > st.k[None, :])     # [B, C]
        eta = self._etas_dev[torch.clamp(st.i, max=len(self.etas) - 1)
                             .to(torch.int64)]
        cand = torch.where(elig, bc_k[:, None], 0)
        best_k = cand.max(dim=0).values
        best = cand.argmax(dim=0)          # first max, as jnp.argmax
        take = best_k > st.k
        k = torch.where(take, best_k, st.k)
        deliver_rows = take.sum(dtype=I32)

        # availability gates compute, credit and completion — an off
        # client accrues nothing and sends nothing this tick
        active = st.i < k + d_gate
        if plan.avail_mask is not None:
            active = active & plan.avail_mask(t)
        credit = st.credit + torch.where(active, accrual, 0)
        s_i = sizes.gather(1, torch.clamp(st.i, max=i_cap)
                           .to(torch.int64)[:, None])[:, 0]
        n = torch.where(active, torch.minimum(s_i - st.h,
                                              credit >> FRAC_BITS), 0)
        n = torch.clamp(n, min=0)
        credit = credit - (n << FRAC_BITS)
        n_block = (n > 0).sum(dtype=I32)
        h = st.h + n

        # round completions
        done = active & (h >= s_i)
        n_done = done.sum(dtype=I32)
        i_new = torch.where(done, st.i + 1, st.i)
        h_new = torch.where(done, 0, h)
        credit_new = torch.where(
            done, torch.clamp(credit, max=block << FRAC_BITS), credit)

        # far tier: updates whose latency reaches past the ring go to the
        # overflow bucket, one slot per distinct arrival tick
        far_counts = []
        if far_tier:
            arr_off = self._update_offsets(st.i)
            far_mask = done & (arr_off >= L)
            grp = far_mask[None, :] & (arr_off[None, :]
                                       == self._far_vals[:, None])   # [V, C]
            oh_r = (st.i & (R - 1))[:, None] == self._ar_R            # [C, R]
            oh_s = (k & (R - 1))[:, None] == self._ar_R
            far_counts = [far_mask.sum(dtype=I32), grp.sum(1, dtype=I32),
                          (grp[:, :, None] & oh_r[None]).sum(1, dtype=I32),
                          (grp[:, :, None] & oh_s[None]).sum(1, dtype=I32)]

        if self.fuse_ticks:
            # int-only preview of tick t + 1's block predicate on the
            # post-tick state (the reference's predict_block)
            elig2 = (bc_at <= t + 1) & (bc_k[:, None] > k[None, :])
            best_k2 = torch.where(elig2, bc_k[:, None], 0).max(dim=0).values
            k2 = torch.where(best_k2 > k, best_k2, k)
            active2 = i_new < k2 + d_gate
            if plan.avail_mask is not None:
                active2 = active2 & plan.avail_mask(t + 1)
            credit2 = credit_new + torch.where(active2, accrual, 0)
            s_i2 = sizes.gather(1, torch.clamp(i_new, max=i_cap)
                                .to(torch.int64)[:, None])[:, 0]
            n2 = torch.where(active2, torch.minimum(s_i2 - h_new,
                                                    credit2 >> FRAC_BITS), 0)
            n_next = (torch.clamp(n2, min=0) > 0).sum(dtype=I32)
        else:
            n_next = self._tick_one

        # the counts across clients, summed over the ranks: one
        # all-reduce where the client axis is cut, nothing otherwise
        (deliver_rows, n_block, n_done, n_next, *far_counts) = axis.allsum(
            [deliver_rows, n_block, n_done, n_next, *far_counts])
        any_block = n_block > 0
        any_done = n_done > 0
        next_no_block = (n_next == 0) if self.fuse_ticks else self._false

        ops = st.ops + torch.stack([
            self._tick_one,                           # ticks
            any_block.to(I32),                        # block_ticks
            has_arr.to(I32),                          # bucket_applies
            (ncasc > 0).to(I32),                      # cascade_ticks
            (deliver_rows > 0).to(I32),               # deliver_ticks
            deliver_rows,                             # deliver_rows
            self._tick_zero,                          # ring_scatters
            any_done.to(I32),                         # complete_ticks
            self._tick_zero,                          # far_ticks
            self._tick_zero,                          # far_groups
        ])

        err, ovf_hwm, far_msgs = st.err, st.ovf_hwm, st.far_msgs
        any_far, far = self._false, None
        if far_tier:
            far_n, grp_n, cnt, cnt_ks = far_counts
            any_far = far_n > 0
            (ovf_at, ovf_cnt, ovf_ks, err, ovf_hwm, far_msgs, ops,
             far) = self._far_plan(t, grp, grp_n, cnt, cnt_ks, far_n,
                                   any_far, ovf_at, ovf_cnt, ovf_ks, err,
                                   ovf_hwm, far_msgs, ops)

        packed = torch.stack([ncasc, deliver_rows, any_block.to(I32),
                              any_done.to(I32), next_no_block.to(I32),
                              any_far.to(I32), err])
        integer.__exit__(None, None, None)
        with maybe_span(rec, "tick.read"):
            preds = TickPreds(*packed.tolist())   # the one sync per tick
        self.host_syncs["tick"] += 1

        # ---- 2) float phase ---------------------------------------------
        # the server's step in one launch: the due ring slot, after the
        # due overflow entry (the reference's order; +0.0 where none is
        # due), applied to v — under FedAsync each sender-k stratum decayed
        # by its staleness, under FedBuff banked and applied on a flush —
        # with the slot, the overflow row and the buffer reset in place
        # and v' pushed into the fired broadcast rows in place.  v' is a
        # new tensor: a model handed out as a view of v must not change.
        # (FedAsync's upd_vec / ovf_vec stay all +0.0: nothing to reset.)
        if strat.stratified:
            due, ovf = st.upd_kvec[slot], st.ovf_kvec
            dec = self._dec_rows[sk0 & (R - 1)]
        else:
            due, ovf = st.upd_vec[slot:slot + 1], st.ovf_vec[:, None]
            dec = self._ones1
        with maybe_span(rec, "server_step"):
            v = server_apply(
                st.v, due, dec, has_arr, reset=True,
                ovf=ovf if far_tier else None,
                ovf_hit=ovf_hit if far_tier else None,
                buf=st.buf_vec if strat.buffered else None, flush=flush,
                bc_v=st.bc_v if preds.cascades else None, fired=fired)
        if rec is not None:
            rec.launches.append(("server_apply", dict(
                D=st.v.shape[0], A=due.shape[0], arr=has_arr,
                fired=fired.sum() if preds.cascades else 0,
                hit=ovf_hit.any() if far_tier else False,
                buffered=strat.buffered,
                flush=flush if strat.buffered else False)))
        upd_vec, upd_kvec, bc_v = st.upd_vec, st.upd_kvec, st.bc_v
        ovf_vec, ovf_kvec, buf_vec = st.ovf_vec, st.ovf_kvec, st.buf_vec
        w = st.w
        if preds.deliver_rows:
            with maybe_span(rec, "deliver"):
                w = tick_deliver(st.w, st.U, bc_v, best, take, eta)
            if rec is not None:
                rec.launches.append(("tick_deliver", dict(
                    C=w.shape[0], D=w.shape[1], nt=take.sum())))
        U = st.U
        if preds.any_block:
            with maybe_span(rec, "client_block", device=True, alloc=True):
                w, U = self.ltask.run_block(w, U, st.i, st.h, n, eta,
                                            self.b_stat)

        messages, part, bytes_up = st.messages, st.part, st.bytes_up
        if preds.any_done:
            done_i = done.to(I32)
            messages = messages + n_done
            part = part + done_i
            bytes_up = bytes_up + done_i * self.upd_bytes
            # update latency addressed by (client, round): st.i is the
            # pre-increment round, as in the reference
            arr_off = self._update_offsets(st.i)
            arr_slot = (t + arr_off) & (L - 1)
            near = done & (arr_off < L) if far_tier else done
            oh_l = (arr_slot[:, None] == self._ar_L) & near[:, None]  # [C, L]
            oh_r = (st.i & (R - 1))[:, None] == self._ar_R            # [C, R]
            oh_s = (k & (R - 1))[:, None] == self._ar_R
            oh_ls = oh_l[:, :, None] & oh_s[:, None, :]             # [C, L, R]
            ring = torch.cat([
                (oh_l[:, :, None] & oh_r[:, None, :]).sum(
                    dim=0, dtype=I32).reshape(-1),
                oh_ls.sum(dim=0, dtype=I32).reshape(-1),
                oh_l.sum(dim=0, dtype=I32)])
            if self.dp_on:
                sent = self._clip_noise(U, eta, done, t)
            else:
                sent = U
            # the ring scatter: one row per near slot, or per (slot,
            # sender-k stratum) under FedAsync, sl-major; then, on ticks
            # that route updates past the ring, the far groups' rows
            with maybe_span(rec, "ring_scatter"):
                if strat.stratified:
                    masks = oh_ls.reshape(-1, L * R).T
                    rows = upd_kvec.reshape(L * R, self.D)
                else:
                    masks = oh_l.T
                    rows = upd_vec
                G = rows.shape[0]
                wgt = eta[None, :] * masks.to(F32)                  # [G, C]
                if preds.any_far:
                    wgt = torch.cat([wgt, self._far_weights(eta, k, far)])
                # the rows pass under the whole axis's partition, its block
                # partials (and the ring counts) gathered from every rank
                w, U, partial, ring = axis.partials(
                    sent, w, U, wgt, done, eta, dp_on=self.dp_on, ints=ring)
                c_lr, c_ls, c_l = ring.split([L * R, L * R, L])
                upd_cnt = upd_cnt + c_lr.reshape(L, R)
                upd_ks = upd_ks + c_ls.reshape(L, R)
                ops[OP_RING_SCATTERS] += (c_l > 0).sum(dtype=I32)
                any_g = (c_ls if strat.stratified else c_l) > 0
                if preds.any_far:
                    any_g = torch.cat([any_g, self._far_on])
                out = tick_scatter_finish(partial, rows, any_g)
                if rec is not None:
                    rec.launches.append(("tick_scatter_finish", dict(
                        nblk=partial.shape[0], G=partial.shape[1],
                        D=partial.shape[2])))
                if strat.stratified:
                    upd_kvec = out[:G].reshape(L, R, self.D)
                else:
                    upd_vec = out[:G]
                if preds.any_far:
                    ovf_vec, ovf_kvec = self._far_insert(out[G:], far,
                                                         ovf_vec, ovf_kvec)

        if not preds.any_done:
            i_new = st.i        # same tensor: the update draws stay cached
        server_k = st.server_k + ncasc
        return st._replace(
            w=w, U=U, v=v, i=i_new, h=h_new, k=k, credit=credit_new,
            server_k=server_k, tick=st.tick + 1, upd_vec=upd_vec,
            upd_cnt=upd_cnt, h_counts=hc, bc_v=bc_v, bc_k=bc_k,
            bc_at=bc_at, ovf_vec=ovf_vec, ovf_at=ovf_at, ovf_cnt=ovf_cnt,
            err=err, messages=messages, broadcasts=st.broadcasts + ncasc,
            part=part, bytes_up=bytes_up, stale_hist=stale_hist,
            upd_ks=upd_ks, ovf_ks=ovf_ks, ovf_hwm=ovf_hwm,
            far_msgs=far_msgs, upd_kvec=upd_kvec, ovf_kvec=ovf_kvec,
            buf_vec=buf_vec, buf_cnt=buf_cnt, ops=ops), preds

    def _clip_noise(self, U, eta, done, t: int):
        """Round-completion DP of the finishing rows, without the kernels'
        weighted sum (agg): the ring scatter re-weights by arrival slot.
        The normals of this rank's rows are those rows of the whole
        ``[C, D]`` draw."""
        rec = self._spans
        with maybe_span(rec, "clip_noise", device=True, alloc=True):
            wts = eta * done.to(F32)
            key = prng.fold_in(self._noise_base, t)        # CPU scalar key
            lo, hi = self.axis.lo, self.axis.hi
            if self.dp_rng == "in_kernel":
                with maybe_span(rec, "clip_noise_kernel"):
                    sent, _ = cohort_clip_noise_prng(
                        U, key, wts, done, clip=self.dp_round_clip,
                        noise_scale=self.noise_scale, with_agg=False,
                        row_offset=lo)
                if rec is not None:
                    rec.launches.append(("cohort_clip_noise_prng", dict(
                        C=U.shape[0], D=U.shape[1], nd=done.sum())))
                return sent
            noise = None
            if self.noise_scale > 0.0:
                with maybe_span(rec, "noise_draw"):
                    noise = prng.normal_rows(key, (self.C, self.D), lo, hi,
                                             device=self.device)
            with maybe_span(rec, "clip_noise_kernel"):
                sent, _ = cohort_clip_noise(U, noise, wts, done,
                                            clip=self.dp_round_clip,
                                            noise_scale=self.noise_scale,
                                            with_agg=False)
            if rec is not None:
                rec.launches.append(("cohort_clip_noise", dict(
                    C=U.shape[0], D=U.shape[1], nd=done.sum(),
                    clip=self.dp_round_clip > 0.0)))
            return sent

    def _far_plan(self, t, grp, grp_n, cnt, cnt_ks, far_n, any_far, ovf_at,
                  ovf_cnt, ovf_ks, err, ovf_hwm, far_msgs, ops):
        """The overflow bucket's integer update for this tick's far
        arrivals, all on the device, from the far groups' counts over
        every client (``grp_n`` [V], ``cnt`` / ``cnt_ks`` [V, R] by round
        and by sender k, ``far_n`` in all).

        The reference inserts the distinct far arrival ticks one by one,
        ascending, at most F of them: a tick that already has a slot
        merges into it, a new tick takes the lowest free slot.  Arrival
        offsets past the ring are exactly the plan's far tick values, so
        the groups are known by value: a group ranked below F is
        processed; unmatched processed groups take the free slots in
        ascending order; a non-empty group that is not written (past F,
        or no free slot) sets the error latch."""
        any_grp = grp_n > 0
        rank = torch.cumsum(any_grp.to(I32), 0) - 1
        proc = any_grp & (rank < self.F)
        tick_q = t + self._far_vals                                   # [V]
        match = ovf_at[None, :] == tick_q[:, None]                    # [V, Q]
        has_match = match.any(1)
        unmatched = proc & ~has_match
        urank = torch.cumsum(unmatched.to(I32), 0) - 1
        free = ovf_at == 0
        frank = torch.cumsum(free.to(I32), 0) - 1
        fsel = (free[None, :] & (frank[None, :] == urank[:, None])
                & unmatched[:, None])
        idx = torch.where(has_match, match.to(I32).argmax(1),
                          fsel.to(I32).argmax(1))
        write = proc & (has_match | fsel.any(1))
        err = err | (any_grp & ~write).any().to(I32)
        wq = write[:, None] & (idx[:, None] == self._ar_Q[None, :])   # [V, Q]
        wq_i = wq.to(I32)
        ovf_cnt = ovf_cnt + (wq_i[:, :, None] * cnt[:, None, :]).sum(
            0, dtype=I32)
        ovf_ks = ovf_ks + (wq_i[:, :, None] * cnt_ks[:, None, :]).sum(
            0, dtype=I32)
        written_q = wq.any(0)
        ovf_at = torch.where(written_q, (wq_i * tick_q[:, None]).sum(0,
                                                                  dtype=I32),
                             ovf_at)
        # occupancy high-water mark, sampled after this tick's inserts,
        # only on ticks that route to the far tier
        ovf_hwm = torch.where(any_far, torch.maximum(
            ovf_hwm, (ovf_at != 0).sum(dtype=I32)), ovf_hwm)
        far_msgs = far_msgs + far_n
        ops[OP_FAR_TICKS] += any_far.to(I32)
        ops[OP_FAR_GROUPS] += proc.sum(dtype=I32)
        plan = _FarPlan(grp=grp, slot_of_q=wq_i.argmax(0),
                        written_q=written_q, any_r=cnt_ks > 0)
        return ovf_at, ovf_cnt, ovf_ks, err, ovf_hwm, far_msgs, ops, plan

    def _far_weights(self, eta, k, far: _FarPlan):
        """The far groups' rows of the scatter weights: ``eta_c`` on each
        group's clients (``[V, C]``), under FedAsync per sender-k stratum
        (``[V * R, C]``, v-major)."""
        g_w = eta[None, :] * far.grp.to(F32)                          # [V, C]
        if not self.strategy.stratified:
            return g_w
        oh_s = (k & (self.R - 1))[:, None] == self._ar_R              # [C, R]
        return (g_w[:, :, None] * oh_s[None].to(F32)).permute(
            0, 2, 1).reshape(-1, g_w.shape[1])

    def _far_insert(self, vecs, far: _FarPlan, ovf_vec, ovf_kvec):
        """Float half of the far tier: each written slot adds its group's
        weighted sum ``sum_c eta_c * sent[c]`` (``vecs``, the scatter's far
        rows in the plan's far-value order); under FedAsync per sender-k
        stratum, each guarded so an empty stratum stays bitwise
        untouched."""
        take = far.slot_of_q
        if self.strategy.stratified:
            vecs = vecs.reshape(-1, self.R, self.D)                 # [V, R, D]
            upd = far.written_q[:, None] & far.any_r[take]          # [Q, R]
            ovf_kvec = torch.where(upd[:, :, None], ovf_kvec + vecs[take],
                                   ovf_kvec)
            return ovf_vec, ovf_kvec
        ovf_vec = torch.where(far.written_q[:, None],
                              ovf_vec + vecs[take], ovf_vec)
        return ovf_vec, ovf_kvec

    # -- segments -----------------------------------------------------------
    def segment(self, target_k: int, tick_limit: int) -> int:
        """Advance ``self._st`` until ``server_k >= target_k``, the tick
        budget runs out or the overflow bucket's error latch is set;
        returns ``server_k``."""
        rec = self._spans
        with maybe_span(rec, "segment"):
            st = self._st
            tick, sk, err = torch.stack([st.tick, st.server_k,
                                         st.err]).tolist()
            self.host_syncs["segment"] += 1
            while sk < target_k and tick < tick_limit and err == 0:
                with maybe_span(rec, "tick", alloc=True, t=tick + 1,
                                fused=False):
                    st, p = self._tick(st, tick + 1, sk)
                tick, sk, err = tick + 1, sk + p.cascades, p.err
                had_block = p.any_block
                if (self.fuse_ticks and sk < target_k and tick < tick_limit
                        and err == 0 and p.next_no_block):
                    # a protocol-only next tick rides in this iteration
                    with maybe_span(rec, "tick", alloc=True, t=tick + 1,
                                    fused=True):
                        st, p = self._tick(st, tick + 1, sk)
                    tick, sk, err = tick + 1, sk + p.cascades, p.err
                    had_block = had_block or p.any_block
                st = st._replace(
                    iters=st.iters + self._iter_inc[int(had_block)])
            self._st = st
        return sk

    @property
    def fused_iters(self):
        """(loop_iters, block_iters): loop iterations executed and how
        many contained a block tick."""
        it = self._st.iters.tolist()
        return int(it[0]), int(it[1])

    @property
    def total_messages(self) -> int:
        return int(self._st.messages)

    @property
    def total_broadcasts(self) -> int:
        return int(self._st.broadcasts)

    @property
    def overflow_slots(self) -> int:
        return self.Q if self.F else 0

    # -- main loop ----------------------------------------------------------
    def run(self, *, max_rounds: int, eval_every: int = 1,
            eval_fn: Optional[Callable] = None,
            max_ticks: Optional[int] = None) -> Dict[str, Any]:
        """Run until the server completes ``max_rounds`` broadcasts; the
        reference's result schema."""
        if eval_fn is not None:
            evals = lambda vec: eval_fn(self.ctask.unflatten(vec))  # noqa: E731
        else:
            evals = self.ctask.metrics
        if max_ticks is None:
            max_ticks = default_max_ticks(
                self.sizes, self.speeds, self.block, max_rounds,
                lat_tail_ticks=self._plan.max_lat_ticks,
                duty=self._plan.duty)
        next_eval = eval_every
        timer = self.timer = SpanRecorder()
        first_segment = True
        while True:
            target = min(next_eval, max_rounds)
            with timer.phase("first_segment" if first_segment
                             else "steady"):
                sk = self.segment(target, max_ticks)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            first_segment = False
            st = self._st
            if sk < target:
                if int(st.err) != 0:
                    raise RuntimeError(
                        f"device engine overflow bucket exhausted at "
                        f"tick {int(st.tick)} (Q={self.Q} slots, "
                        f"F={self.F} far groups/tick, ring L={self.L}): "
                        f"too many distinct far arrival ticks in flight "
                        f"— raise Scenario.ring_cap (now "
                        f"{self._plan.scenario.ring_cap}) or shorten the "
                        f"latency tail")
                raise RuntimeError(
                    f"cohort engine stalled: {int(st.tick)} ticks, "
                    f"server_k={sk} < {max_rounds} (in flight: "
                    f"{int(st.upd_cnt.sum()) + int(st.ovf_cnt.sum())} "
                    f"updates, {int((st.bc_at > st.tick).any(1).sum())} "
                    f"broadcasts)")
            if sk >= next_eval:
                with timer.phase("eval"):
                    m = evals(st.v)
                    m.update(round=sk, time=int(st.tick) * self.dt,
                             messages=int(st.messages))
                    self.history.append(m)
                    next_eval = sk + eval_every
                    self._emit_segment()
            if sk >= max_rounds:
                break
        with timer.phase("eval"):
            final = evals(st.v)
        final.update(round=sk, time=int(st.tick) * self.dt,
                     messages=int(st.messages),
                     broadcasts=int(st.broadcasts),
                     overflow_hwm=int(st.ovf_hwm),
                     overflow_slots=self.overflow_slots,
                     far_messages=int(st.far_msgs))
        report = self.telemetry_report(wall=timer.as_dict())
        if self._trace:
            self._trace.emit("report", **report.to_dict())
            self._trace.close()
        return {"final": final, "history": self.history,
                "model": self.ctask.unflatten(st.v), "telemetry": report}

    # -- telemetry ----------------------------------------------------------
    def _emit_segment(self) -> None:
        """A segment record (rank 0 writes; every rank takes part in the
        gather of the per-client counters)."""
        if not self._trace_on:
            return
        st = self._st
        bytes_up_total = int(self._bytes_up().sum())
        if not self._trace:
            return
        self._trace.emit(
            "segment", engine="device", round=int(st.server_k),
            tick=int(st.tick), time=int(st.tick) * self.dt,
            messages=int(st.messages), broadcasts=int(st.broadcasts),
            bytes_up_total=bytes_up_total,
            staleness_hist=st.stale_hist.cpu().numpy(),
            overflow_hwm=int(st.ovf_hwm), ops=st.ops.cpu().numpy())

    def _participation(self) -> np.ndarray:
        """Updates sent per client, int64, over the whole population (a
        cut client axis gathered from every rank)."""
        return (self.axis.gather_rows(self._st.part).cpu().numpy()
                .astype(np.int64))

    def _bytes_up(self, part: Optional[np.ndarray] = None) -> np.ndarray:
        """Uplink bytes per client, int64: every update message of a run
        has one size, so messages x size.  The state's int32 counter (the
        reference's layout) wraps past 2**31 bytes, one message of a
        model of 5.4e8 parameters."""
        if part is None:
            part = self._participation()
        return part * self.upd_bytes

    def telemetry_report(self, wall=None):
        """MetricsReport from the on-device counters (reads the state;
        over a cut client axis every rank calls it: it gathers)."""
        st = self._st
        src_task = self.ctask.task
        part = self._participation()
        return build_report(
            engine="device", clients=self.C, flat_dim=self.D,
            rounds=int(st.server_k), messages=int(st.messages),
            broadcasts=int(st.broadcasts),
            participation=part,
            bytes_up=self._bytes_up(part),
            staleness_hist=st.stale_hist.cpu().numpy().astype(np.int64),
            overflow_hwm=int(st.ovf_hwm),
            overflow_slots=self.overflow_slots,
            far_messages=int(st.far_msgs), ticks=int(st.tick),
            ops=st.ops.cpu().numpy().astype(np.int64),
            dp_sigma=self.dp_sigma, dp_delta=self.dp_delta,
            n_examples=(int(src_task.X.shape[0])
                        if hasattr(src_task, "X") else None),
            sizes_per_client=self.sizes, wall=wall)
