#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. every kernel against its plain PyTorch version at the shapes of the
   main run (bitwise where the kernel keeps the plain version's
   rounding, within a stated tolerance where it reorders a sum), twice
   for identical bits, with its median time (CUDA graph of launches,
   CUDA events), its bound and the plain version's time; also
   ``bucket_apply`` at FedAsync's ``A = R`` with decay weights and
   ``tick_scatter`` at its ``G = L * R``, and the in-kernel noise's
   counter stream bit for bit;
2. the FedSGD census case (C = 4096), whose integer op census must
   reproduce the reference's, and a small DP case that must agree with
   the port's plain CPU run;
3. the main run: the paper's DP configuration (Fig. 1b sizes and step
   sizes, sigma = 8, clip 0.1) on MNIST-width logistic regression
   (D = 785) over C = 16384 clients, with every kernel's launch count,
   then the same with the noise generated in the kernel;
4. the scenarios: the same configuration under ``mobile_diurnal`` with
   FedAsync and under ``iot_straggler`` with FedBuff and a ring of 2
   ticks (updates spill into the overflow bucket), in-kernel noise,
   each repeated with operand noise (identical integer state);
5. a small stratified + overflow + DP case on the card against the
   port's plain CPU run, with both noise sources.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; so does a machine without CUDA.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W; the int32
# rate, non-tensor, from the Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT32_OPS = 33.5e12
# int32 operations of one element of the in-kernel noise: threefry2x32
# (2 key adds, 20 rounds of add + rotate (shift, shift, or) + xor, 5 key
# injections of 3 adds) and the two shifts that take the top 24 bits
PRNG_INT_OPS = 2 + 20 * 5 + 5 * 3 + 2
# f32 operations of that element: Box-Muller (u1: mul + add; u2: mul;
# -2 log u1: log + mul; sqrt; 2 pi u2: mul; cos; the product) and the
# clip + noise + weighted-sum tile math (4 mul + 2 add)
PRNG_F32_OPS = 10 + 6

# the main run: paper_logreg at its source's widest width (MNIST, 784
# features) with Fig. 1b's DP protocol
MAIN = dict(n=60_000, d=784, C=16_384, d_gate=2, rounds=8, block=64,
            seed=0)
# the scenario runs: the main configuration under two presets, depth
# cut to keep each run (and its operand-noise repeat) near a minute.
# iot_straggler's largest latency bin is 1.84 s (its Pareto table's
# upper edge, q 0.99, is 4.6 s), so only a tick shorter than that (dt =
# block = 1 s) sends updates past a 2-tick ring into the overflow bucket
SCENARIOS = (
    dict(tag="mobile_diurnal+fedasync", scenario="mobile_diurnal",
         strategy=("fedasync", {}), block=4, ring_cap=None, rounds=8),
    dict(tag="iot_straggler+fedbuff", scenario="iot_straggler",
         strategy=("fedbuff", {"buffer_size": 4}), block=1, ring_cap=2,
         rounds=1),
)
# FedSGD census case (benchmarks/bench_cohort_scale.py run_fused_tick,
# C = 4096): op census and iteration census recorded in
# BENCH_cohort.json["fused_tick"]["4096"]["after"]
FEDSGD_C = 4096
FEDSGD_OPS = dict(ticks=16, block_ticks=8, deliver_rows=28672)
FEDSGD_ITERS = (8, 8)

# tolerances where a kernel reorders a float sum: the error of a
# reordered f32 sum of n terms is bounded by a small multiple of
# eps * sum|terms|; 1e-5 * sum|terms| leaves ~80x eps(f32) of room
SUM_RTOL = 1e-5
# out rows of cohort_clip_noise with clip > 0: the row norm may differ by
# a few ulp, so each element by a few ulp of |u*s| + |noise term|
ROW_RTOL = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def median_ms(fn, n: int = 10, reps: int = 7) -> float:
    """Median device time of one call: a CUDA graph of ``n`` calls,
    replayed ``reps`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_terms(nbytes: float, flops: float, int_ops: float = 0.0):
    """(bytes ms, operations ms): the bytes over the memory rate, the
    operations over the peak rate of their type (f32 and int32 run on
    separate units, so the operations take the longer of the two)."""
    t_o = max(flops / F32_FLOPS, int_ops / INT32_OPS)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * t_o


def bound(nbytes: float, flops: float, int_ops: float = 0.0):
    t_b, t_o = bound_terms(nbytes, flops, int_ops)
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def phase_kernels(dev):
    """Phase 1: each kernel against its plain version at the main run's
    shapes; returns the kernels' JSON entries (launches filled later)."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                               cohort_clip_noise_prng,
                                               cohort_clip_noise_prng_ref,
                                               counter_normals)
    from repro_torch.kernels.cohort_dp.kernel import prng_words_probe
    from repro_torch.kernels.cohort_dp.ref import cohort_clip_noise_ref
    from repro_torch.kernels.tick_fused import (bucket_apply,
                                                bucket_apply_ref,
                                                tick_deliver,
                                                tick_deliver_ref,
                                                tick_scatter,
                                                tick_scatter_ref)

    from repro_torch.cohort.state import next_pow2

    C, D = MAIN["C"], MAIN["d"] + 1
    B = next_pow2(MAIN["d_gate"] + 2)
    L = 2                              # uniform plan at dt = block: ring of 2
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    def rand(*s):
        return torch.rand(s, generator=g, device=dev)

    out = []
    f4 = 4

    # -- bucket_apply: A = 1, a -0.0 row against a -0.0 server vector ----
    v = randn(D)
    rows = randn(1, D)
    v[:16] = -0.0
    rows[0, :16] = -0.0
    dec = torch.ones(1, device=dev)
    err = 0.0
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        k1 = bucket_apply(v, rows, dec, fl)
        k2 = bucket_apply(v, rows, dec, fl)
        p = bucket_apply_ref(v, rows, dec, fl)
        if not (bits_equal(k1, p) and bits_equal(k1, k2)):
            fail(f"bucket_apply (flag={flag}) is not bitwise equal to its "
                 f"plain version / itself")
        err = max(err, float((k1 - p).abs().max()))
    fl = torch.tensor(True, device=dev)
    ms = median_ms(lambda: bucket_apply(v, rows, dec, fl))
    pms = median_ms(lambda: bucket_apply_ref(v, rows, dec, fl))
    bms, by = bound(f4 * (3 * D + 1) + 4, 2 * D)
    out.append(dict(name="bucket_apply", route="cuda",
                    source="src/repro_torch/csrc/tick_fused.cu",
                    replaces="src/repro/kernels/tick_fused/kernel.py:78",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    # -- tick_deliver ------------------------------------------------------
    w, U, bc_v = randn(C, D), randn(C, D), randn(B, D)
    best = torch.randint(0, B, (C,), generator=g, device=dev)
    take = rand(C) < 0.7
    eta = 0.1 * rand(C)
    k1 = tick_deliver(w, U, bc_v, best, take, eta)
    k2 = tick_deliver(w, U, bc_v, best, take, eta)
    p = tick_deliver_ref(w, U, bc_v, best, take, eta)
    if not (bits_equal(k1, p) and bits_equal(k1, k2)):
        fail("tick_deliver is not bitwise equal to its plain version / "
             "itself")
    ms = median_ms(lambda: tick_deliver(w, U, bc_v, best, take, eta))
    pms = median_ms(lambda: tick_deliver_ref(w, U, bc_v, best, take, eta))
    nt = int(take.sum())
    # taken rows read U, the others w; every row is written
    bms, by = bound(f4 * (2 * C * D + B * D + C) + 8 * C + C, 2 * nt * D)
    out.append(dict(name="tick_deliver", route="cuda",
                    source="src/repro_torch/csrc/tick_fused.cu",
                    replaces="src/repro/kernels/tick_fused/kernel.py:102",
                    max_abs_err=float((k1 - p).abs().max()), ms=ms,
                    plain_ms=pms, bound_ms=bms, bound_by=by,
                    library_ms=None))

    # -- tick_scatter: ring row 1 receives nobody (guarded add) -----------
    sent, upd = randn(C, D), randn(L, D)
    done = rand(C) < 0.5
    in_ls = [done, torch.zeros_like(done)]
    wgt = torch.stack([eta * m.to(torch.float32) for m in in_ls])
    any_g = torch.stack([m.any() for m in in_ls])
    kw1 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    kw2 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    pw = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    for a, b, what in ((kw1[0], pw[0], "w"), (kw1[1], pw[1], "U")):
        if not bits_equal(a, b):
            fail(f"tick_scatter {what} output is not bitwise equal to its "
                 f"plain version")
    if not all(bits_equal(a, b) for a, b in zip(kw1, kw2)):
        fail("tick_scatter: two launches differ")
    if not bits_equal(kw1[2][1], upd[1]):
        fail("tick_scatter: the empty ring row changed (guarded add)")
    absum = wgt.abs() @ sent.abs()                     # [G, D] sum|terms|
    diff = (kw1[2] - pw[2]).abs()
    if not bool((diff <= SUM_RTOL * absum + 1e-30).all()):
        fail(f"tick_scatter ring rows off by {float(diff.max())} "
             f"(> {SUM_RTOL} * sum|terms|)")
    err = max(float((a - b).abs().max()) for a, b in zip(kw1, pw))
    ms = median_ms(lambda: tick_scatter(sent, w, U, upd, wgt, any_g, done,
                                        eta, dp_on=True))
    pms = median_ms(lambda: tick_scatter_ref(sent, w, U, upd, wgt, any_g,
                                             done, eta, dp_on=True))
    nd = int(done.sum())
    G = L
    # read sent and w, U on done rows, upd, wgt, masks; write w, U, upd
    bms, by = bound(f4 * (2 * C * D + nd * D + 2 * G * D + G * C + C
                          + 2 * C * D) + G + C,
                    2 * G * C * D + 3 * nd * D)
    out.append(dict(name="tick_scatter", route="cuda",
                    source="src/repro_torch/csrc/tick_fused.cu",
                    replaces="src/repro/kernels/tick_fused/kernel.py:129",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    # -- cohort_clip_noise: clip > 0 and clip = 0 -------------------------
    u = 0.05 * randn(C, D) * (2.0 * rand(C))[:, None]   # norms in [0, 2.8]
    noise = randn(C, D)
    mask = done
    wts = eta * mask.to(torch.float32)
    ns = 0.1 * 8.0
    err = 0.0
    for clip in (1.0, 0.0):
        o1, a1 = cohort_clip_noise(u, noise, wts, mask, clip=clip,
                                   noise_scale=ns)
        o2, a2 = cohort_clip_noise(u, noise, wts, mask, clip=clip,
                                   noise_scale=ns)
        po, pa = cohort_clip_noise_ref(u, noise, wts, mask, clip=clip,
                                       noise_scale=ns)
        if not (bits_equal(o1, o2) and bits_equal(a1, a2)):
            fail(f"cohort_clip_noise (clip={clip}): two launches differ")
        if clip == 0.0 and not bits_equal(o1, po):
            fail("cohort_clip_noise (clip=0) rows are not bitwise equal "
                 "to the plain version")
        row_tol = ROW_RTOL * (u.abs() + ns * noise.abs())
        if not bool(((o1 - po).abs() <= row_tol).all()):
            fail(f"cohort_clip_noise (clip={clip}) rows off by "
                 f"{float((o1 - po).abs().max())}")
        agg_tol = SUM_RTOL * (wts.abs() @ po.abs())
        if not bool(((a1 - pa).abs() <= agg_tol + 1e-30).all()):
            fail(f"cohort_clip_noise (clip={clip}) agg off by "
                 f"{float((a1 - pa).abs().max())}")
        err = max(err, float((o1 - po).abs().max()),
                  float((a1 - pa).abs().max()))
    # timed as the main run calls it: no round clip, noise on
    ms = median_ms(lambda: cohort_clip_noise(u, noise, wts, mask, clip=0.0,
                                             noise_scale=ns))
    pms = median_ms(lambda: cohort_clip_noise_ref(u, noise, wts, mask,
                                                  clip=0.0, noise_scale=ns))
    # read u and the noise of masked rows, mask, weights; write out, agg
    bms, by = bound(f4 * (C * D + nd * D + 2 * C + C * D + D),
                    4 * C * D + 2 * C * D)
    out.append(dict(name="cohort_clip_noise", route="cuda",
                    source="src/repro_torch/csrc/cohort_dp.cu",
                    replaces="src/repro/kernels/cohort_dp/kernel.py:103",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    # -- cohort_clip_noise_prng: the stream, then clip > 0 and clip = 0 ----
    key = prng.fold_in(prng.PRNGKey(MAIN["seed"] ^ NOISE_SALT), 1)
    w0, w1 = prng_words_probe(key, C * D, dev)
    p0, p1 = prng.counter_words(key, C * D, device=dev)
    if not (torch.equal(w0, p0) and torch.equal(w1, p1)):
        fail("cohort_clip_noise_prng: the kernel's threefry stream differs "
             "from repro_torch.prng on the flat index")
    del w0, w1, p0, p1
    n = counter_normals(key, C, D, device=dev)
    err = 0.0
    for clip in (1.0, 0.0):
        o1, a1 = cohort_clip_noise_prng(u, key, wts, mask, clip=clip,
                                        noise_scale=ns)
        o2, a2 = cohort_clip_noise_prng(u, key, wts, mask, clip=clip,
                                        noise_scale=ns)
        po, pa = cohort_clip_noise_prng_ref(u, key, wts, mask, clip=clip,
                                            noise_scale=ns)
        if not (bits_equal(o1, o2) and bits_equal(a1, a2)):
            fail(f"cohort_clip_noise_prng (clip={clip}): two launches "
                 f"differ")
        if not bits_equal(o1[~mask], u[~mask]):
            fail("cohort_clip_noise_prng: pass-through rows are not u")
        # CUDA's logf / cosf against PyTorch's log / cos: a few ulp of n
        row_tol = ROW_RTOL * (u.abs() + ns * n.abs())
        if not bool(((o1 - po).abs() <= row_tol).all()):
            fail(f"cohort_clip_noise_prng (clip={clip}) rows off by "
                 f"{float((o1 - po).abs().max())}")
        agg_tol = SUM_RTOL * (wts.abs() @ po.abs())
        if not bool(((a1 - pa).abs() <= agg_tol + 1e-30).all()):
            fail(f"cohort_clip_noise_prng (clip={clip}) agg off by "
                 f"{float((a1 - pa).abs().max())}")
        err = max(err, float((o1 - po).abs().max()),
                  float((a1 - pa).abs().max()))
    del n, o1, o2, po
    ms = median_ms(lambda: cohort_clip_noise_prng(u, key, wts, mask,
                                                  clip=0.0, noise_scale=ns))
    pms = median_ms(lambda: cohort_clip_noise_prng_ref(
        u, key, wts, mask, clip=0.0, noise_scale=ns), n=3, reps=3)
    # read u, mask, weights; write out, agg.  Every element draws its
    # normal (a pass-through row adds (ns * 0) * n, as the operand kernel)
    nbytes = f4 * (C * D + 2 * C + C * D + D)
    b_ms, o_ms = bound_terms(nbytes, PRNG_F32_OPS * C * D,
                             PRNG_INT_OPS * C * D)
    bms, by = bound(nbytes, PRNG_F32_OPS * C * D, PRNG_INT_OPS * C * D)
    print(f"phase kernels: cohort_clip_noise_prng C={C} D={D} "
          f"bound_bytes_ms={b_ms} bound_ops_ms={o_ms} "
          f"(int32 {PRNG_INT_OPS}/elt, f32 {PRNG_F32_OPS}/elt)")
    out.append(dict(name="cohort_clip_noise_prng", route="cuda",
                    source="src/repro_torch/csrc/cohort_dp.cu",
                    replaces="src/repro/kernels/cohort_dp/kernel.py:139",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    # -- FedAsync's shapes: bucket_apply at A = R, tick_scatter at G = L*R
    R = B
    rows_r = randn(R, D)
    rows_r[2] = 0.0                              # an empty stratum
    dec_r = 0.6 * (torch.arange(R, device=dev, dtype=torch.float32)
                   + 1.0) ** -0.5
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        k1 = bucket_apply(v, rows_r, dec_r, fl)
        if not bits_equal(k1, bucket_apply(v, rows_r, dec_r, fl)):
            fail("bucket_apply (A = R): two launches differ")
        p = bucket_apply_ref(v, rows_r, dec_r, fl)
        tol = SUM_RTOL * (dec_r.abs() @ rows_r.abs())
        if not bool(((k1 - p).abs() <= tol + 1e-30).all()):
            fail(f"bucket_apply (A = R, flag={flag}) off by "
                 f"{float((k1 - p).abs().max())}")
        if not flag and not bits_equal(k1, v):
            fail("bucket_apply (A = R): flag off changed v")
    G = L * R
    slot = torch.randint(0, L, (C,), generator=g, device=dev)
    kmod = torch.randint(0, R, (C,), generator=g, device=dev)
    masks = torch.stack([done & (slot == sl) & (kmod == r)
                         for sl in range(L) for r in range(R)])
    masks[G - 1] = False                         # a row nobody reaches
    wgt = eta[None, :] * masks.float()
    any_g = masks.any(1)
    upd = randn(G, D)
    kw1 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    kw2 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    pw = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    if not (bits_equal(kw1[0], pw[0]) and bits_equal(kw1[1], pw[1])):
        fail("tick_scatter (G = L * R): w / U not bitwise")
    if not all(bits_equal(a, b) for a, b in zip(kw1, kw2)):
        fail("tick_scatter (G = L * R): two launches differ")
    if not bits_equal(kw1[2][G - 1], upd[G - 1]):
        fail("tick_scatter (G = L * R): the empty row changed")
    diff = (kw1[2] - pw[2]).abs()
    if not bool((diff <= SUM_RTOL * (wgt.abs() @ sent.abs()) + 1e-30).all()):
        fail(f"tick_scatter (G = L * R) rows off by {float(diff.max())}")
    gms = median_ms(lambda: tick_scatter(sent, w, U, upd, wgt, any_g, done,
                                         eta, dp_on=True))
    print(f"phase kernels: FedAsync shapes ok: bucket_apply A={R} "
          f"dec={dec_r.tolist()}; tick_scatter G={G} ms={gms} "
          f"max_abs_err={float(diff.max())}")
    return out


def make_sim(dev, X, y, *, C, sizes, etas, d, seed, block, l2,
             dp_clip=0.0, dp_sigma=0.0, dp_round_clip=0.0, sample_seed=0,
             scenario=None, strategy=None, dp_rng="operand"):
    import repro_torch as rt
    task = rt.LogRegTask(X, y, l2=l2, dp_clip=dp_clip, dp_sigma=dp_sigma,
                         sample_seed=sample_seed)
    return rt.DeviceCohortSimulator(
        task, n_clients=C, sizes_per_client=sizes, round_stepsizes=etas,
        d=d, seed=seed, block=block, dp_round_clip=dp_round_clip,
        scenario=scenario, strategy=strategy, dp_rng=dp_rng, device=dev)


def timed_run(sim, rounds, eval_every):
    import torch
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(max_rounds=rounds, eval_every=eval_every)
    return res, time.perf_counter() - t0


def run_sim(dev, X, y, *, rounds, eval_every, **kw):
    sim = make_sim(dev, X, y, **kw)
    res, wall = timed_run(sim, rounds, eval_every)
    return sim, res, wall


def time_noise(eng):
    """Record CUDA events around each round-completion noise call of the
    engine (no host sync); returns a function giving the summed ms."""
    import torch
    spans = []
    inner = eng._clip_noise

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out

    eng._clip_noise = timed
    return lambda: sum(a.elapsed_time(b) for a, b in spans)


class count_normal_draws:
    """Count ``repro_torch.prng.normal`` calls (the operand noise draw)
    while the context is open."""

    def __enter__(self):
        from repro_torch import prng
        self.n, self._inner = 0, prng.normal

        def counted(*a, **k):
            self.n += 1
            return self._inner(*a, **k)

        prng.normal = counted
        return self

    def __exit__(self, *exc):
        from repro_torch import prng
        prng.normal = self._inner


def int_state(eng):
    """The integer protocol state: every int32 state field, the
    iteration census, on the CPU."""
    import torch
    st = eng.state
    return {f: getattr(st, f).cpu() for f in st._fields
            if getattr(st, f).dtype == torch.int32}


def phase_census(dev):
    """Phase 2: FedSGD census at C = 4096, and a small DP run against the
    port's own plain CPU run."""
    import numpy as np
    import torch
    import repro_torch as rt

    X, y = rt.make_binary_dataset(2048, 32, seed=0, noise=0.3)
    sim, res, wall = run_sim(dev, X, y, C=FEDSGD_C, sizes=[1] * 8,
                             etas=[0.1] * 8, d=1, seed=0, block=64,
                             rounds=8, eval_every=8, l2=1.0 / 2048)
    ops = res["telemetry"].ops
    for k, want in FEDSGD_OPS.items():
        if ops[k] != want:
            fail(f"FedSGD census {k}={ops[k]}, want {want}")
    if sim.engine.fused_iters != FEDSGD_ITERS:
        fail(f"FedSGD fused_iters={sim.engine.fused_iters}, want "
             f"{FEDSGD_ITERS}")
    print(f"phase fedsgd_census: C={FEDSGD_C} ops={ops} "
          f"fused_iters={sim.engine.fused_iters} wall_s={wall} "
          f"client_rounds_per_s={FEDSGD_C * 8 / wall}")

    # small DP case: the card against the plain versions on the CPU
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    kw = dict(C=6, sizes=[4, 6, 8], etas=[0.1, 0.08, 0.06], d=2, seed=2,
              block=4, rounds=3, eval_every=1, l2=1.0 / 300, dp_clip=0.1,
              dp_sigma=8.0, dp_round_clip=1.0, sample_seed=21)
    _, gpu, wall = run_sim(dev, X, y, **kw)
    _, cpu, _ = run_sim(torch.device("cpu"), X, y, **kw)
    for k in ("round", "messages", "broadcasts"):
        if gpu["final"][k] != cpu["final"][k]:
            fail(f"small DP run: {k} {gpu['final'][k]} != {cpu['final'][k]}")
    if gpu["telemetry"].ops != cpu["telemetry"].ops:
        fail("small DP run: op census differs between card and CPU")
    lg = np.array([h["loss"] for h in gpu["history"]])
    lc = np.array([h["loss"] for h in cpu["history"]])
    if not np.allclose(lg, lc, rtol=1e-5, atol=1e-7):
        fail(f"small DP run: losses {lg} vs CPU {lc}")
    print(f"phase small_dp_agreement: losses card={lg.tolist()} "
          f"cpu={lc.tolist()} max_rel={float(np.max(np.abs(lg - lc) / lc))}"
          f" wall_s={wall}")


def main_inputs():
    import repro_torch as rt
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.core.sequences import sample_sizes
    from repro_torch.core.stepsizes import round_stepsizes
    cfg = fl_config_fig1b()
    m = MAIN
    X, y = rt.make_binary_dataset(m["n"], m["d"], seed=m["seed"], noise=0.3)
    sizes = sample_sizes(cfg.sample_seq, m["rounds"] + m["d_gate"] + 1)
    etas = round_stepsizes(cfg.step_size, sizes)
    kw = dict(C=m["C"], sizes=sizes, etas=etas, d=m["d_gate"],
              seed=m["seed"], l2=1.0 / m["n"], dp_clip=cfg.dp.clip_norm,
              dp_sigma=cfg.dp.sigma)
    return X, y, kw


def phase_main(dev, X, y, kw):
    """Phase 3: the main run, with the kernels' launch counts; then the
    same configuration with the noise generated in the kernel."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.telemetry import check_ops

    m = MAIN
    out = {}
    for dp_rng in ("operand", "in_kernel"):
        sim = make_sim(dev, X, y, block=m["block"], dp_rng=dp_rng, **kw)
        eng = sim.engine
        noise_ms = time_noise(eng)
        torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        with count_normal_draws() as draws:
            res, wall = timed_run(sim, m["rounds"], m["rounds"] // 2)
        counts = dict(launches.LAUNCHES)
        tel = res["telemetry"]
        if res["final"]["round"] < m["rounds"]:
            fail(f"main run ({dp_rng}) reached round "
                 f"{res['final']['round']}")
        probs = check_ops(tel.ops, messages=tel.messages,
                          broadcasts=tel.broadcasts,
                          far_messages=tel.far_messages, clients=m["C"],
                          ticks=tel.ticks, loop_iters=eng.fused_iters[0],
                          block_iters=eng.fused_iters[1])
        if probs:
            fail(f"main run ({dp_rng}) op census: {probs}")
        losses = [h["loss"] for h in res["history"]] + [res["final"]["loss"]]
        if not all(math.isfinite(x) for x in losses):
            fail(f"main run ({dp_rng}) losses not finite: {losses}")
        v = res["model"]["w"]
        if tuple(v.shape) != (m["d"],) or not bool(torch.isfinite(v).all()):
            fail("main run model has the wrong shape or is not finite")
        noise_kernel = ("cohort_clip_noise" if dp_rng == "operand"
                        else "cohort_clip_noise_prng")
        other = ("cohort_clip_noise_prng" if dp_rng == "operand"
                 else "cohort_clip_noise")
        for name in ("bucket_apply", "tick_deliver", "tick_scatter",
                     noise_kernel):
            if counts[name] <= 0:
                fail(f"kernel {name} was not launched on the main run "
                     f"({dp_rng})")
        if counts[other] or (dp_rng == "in_kernel" and draws.n):
            fail(f"main run ({dp_rng}) drew noise the other way: "
                 f"{counts}, {draws.n} prng.normal draws")
        ticks = tel.ticks
        print(f"phase main ({dp_rng}): C={m['C']} D={m['d'] + 1} "
              f"rounds={m['rounds']} sizes={kw['sizes']} ticks={ticks} "
              f"ops={tel.ops} fused_iters={eng.fused_iters} "
              f"host_syncs={eng.host_syncs} losses={losses} wall_s={wall} "
              f"noise_ms={noise_ms()} normal_draws={draws.n} "
              f"client_rounds_per_s={m['C'] * m['rounds'] / wall} "
              f"ms_per_tick={1e3 * wall / ticks} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9} "
              f"wall_phases={tel.wall} launches={counts}")
        if dp_rng == "operand":
            eps = [r["epsilon"] for r in (tel.dp or [])
                   if r["epsilon"] is not None]
            print(f"phase main: dp rows={len(tel.dp or [])} "
                  f"max_epsilon={max(eps) if eps else None}")
        out[dp_rng] = counts
    return out["operand"]


def phase_scenarios(dev, X, y, kw):
    """Phase 4: the main configuration under two scenario presets and
    strategies with in-kernel noise (the slice's path: counts zeroed
    before its first run, read after its last), each repeated with
    operand noise: the integer state must be identical."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.kernels import launches
    from repro_torch.scenarios import get_scenario

    runs = {}
    launches.reset()
    for dp_rng in ("in_kernel", "operand"):
        if dp_rng == "operand":
            path_counts = dict(launches.LAUNCHES)
            launches.reset()
        for sc in SCENARIOS:
            scn = get_scenario(sc["scenario"])
            if sc["ring_cap"] is not None:
                scn = dataclasses.replace(scn, ring_cap=sc["ring_cap"])
            kind, hp = sc["strategy"]
            strat = (rt.core.FedAsyncStrategy(**hp) if kind == "fedasync"
                     else rt.core.FedBuffStrategy(**hp))
            sim = make_sim(dev, X, y, block=sc["block"], scenario=scn,
                           strategy=strat, dp_rng=dp_rng, **kw)
            eng = sim.engine
            noise_ms = time_noise(eng)
            torch.cuda.reset_peak_memory_stats(dev)
            before = dict(launches.LAUNCHES)
            with count_normal_draws() as draws:
                res, wall = timed_run(sim, sc["rounds"], sc["rounds"])
            counts = {k: launches.LAUNCHES[k] - before[k] for k in before}
            fin, tel = res["final"], res["telemetry"]
            if fin["round"] < sc["rounds"]:
                fail(f"{sc['tag']} ({dp_rng}) reached round {fin['round']}")
            if eng.host_syncs["tick"] != tel.ticks:
                fail(f"{sc['tag']} ({dp_rng}): {eng.host_syncs['tick']} "
                     f"host syncs for {tel.ticks} ticks")
            if dp_rng == "in_kernel" and (draws.n
                                          or counts["cohort_clip_noise"]):
                fail(f"{sc['tag']}: in-kernel noise drew operand noise")
            if sc["ring_cap"] is not None and not (
                    eng.F > 0 and fin["far_messages"] > 0):
                fail(f"{sc['tag']}: no far-tier traffic (F={eng.F}, "
                     f"far_messages={fin['far_messages']})")
            loss = fin["loss"]
            if not math.isfinite(loss):
                fail(f"{sc['tag']} ({dp_rng}) loss {loss}")
            print(f"phase scenarios {sc['tag']} ({dp_rng}): C={eng.C} "
                  f"D={eng.D} block={sc['block']} L={eng.L} R={eng.R} "
                  f"F={eng.F} Q={eng.Q} rounds={sc['rounds']} "
                  f"ticks={tel.ticks} wall_s={wall} "
                  f"ms_per_tick={1e3 * wall / tel.ticks} "
                  f"noise_ms={noise_ms()} fused_iters={eng.fused_iters} "
                  f"host_syncs_per_tick="
                  f"{eng.host_syncs['tick'] / tel.ticks} "
                  f"overflow_hwm={fin['overflow_hwm']} "
                  f"overflow_slots={fin['overflow_slots']} "
                  f"far_messages={fin['far_messages']} "
                  f"messages={fin['messages']} ops={tel.ops} loss={loss} "
                  f"peak_mem_gb="
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9} "
                  f"launches={counts}")
            runs[(sc["tag"], dp_rng)] = (int_state(eng), eng.fused_iters,
                                         loss)
    for name in ("bucket_apply", "tick_deliver", "tick_scatter",
                 "cohort_clip_noise_prng"):
        if path_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the scenario runs")
    for sc in SCENARIOS:
        a, b = runs[(sc["tag"], "in_kernel")], runs[(sc["tag"], "operand")]
        bad = [f for f in a[0] if not torch.equal(a[0][f], b[0][f])]
        if bad or a[1] != b[1]:
            fail(f"{sc['tag']}: integer state differs between in-kernel "
                 f"and operand noise in {bad or 'fused_iters'}")
        print(f"phase scenarios {sc['tag']}: integer state identical "
              f"between noise sources ({len(a[0])} int32 fields); losses "
              f"in_kernel={a[2]} operand={b[2]}")
    print(f"phase scenarios: launches on the in-kernel runs {path_counts}")
    return path_counts


def phase_small_scenario(dev):
    """Phase 5: a small stratified + overflow + DP case (the reference's
    overflow scenario with FedAsync) on the card against the port's
    plain CPU run, with both noise sources."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.scenarios import LatencyTable, Scenario

    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    scn = Scenario("tail", LatencyTable.from_uniform(1.0, 200.0, 16),
                   ring_cap=8)
    kw = dict(C=6, sizes=[4, 6], etas=[0.1, 0.08], d=2, seed=2, block=4,
              l2=1.0 / 300, dp_clip=0.1, dp_sigma=2.0, dp_round_clip=0.5,
              sample_seed=21, scenario=scn, strategy="fedasync",
              rounds=3, eval_every=1)
    for dp_rng in ("in_kernel", "operand"):
        gsim, gpu, wall = run_sim(dev, X, y, dp_rng=dp_rng, **kw)
        csim, cpu, _ = run_sim(torch.device("cpu"), X, y, dp_rng=dp_rng,
                               **kw)
        if gsim.engine.F <= 0 or gpu["final"]["far_messages"] <= 0:
            fail("small scenario case: no far-tier traffic")
        gi, ci = int_state(gsim.engine), int_state(csim.engine)
        bad = [f for f in gi if not torch.equal(gi[f], ci[f])]
        if bad:
            fail(f"small scenario case ({dp_rng}): integer fields {bad} "
                 f"differ between card and CPU")
        lg = np.array([h["loss"] for h in gpu["history"]])
        lc = np.array([h["loss"] for h in cpu["history"]])
        mg = gpu["model"]["w"].cpu().numpy()
        mc = cpu["model"]["w"].numpy()
        if not (np.allclose(lg, lc, rtol=1e-5, atol=1e-7)
                and np.allclose(mg, mc, rtol=1e-5, atol=1e-7)):
            fail(f"small scenario case ({dp_rng}): card {lg} vs CPU {lc}, "
                 f"model off by {float(np.abs(mg - mc).max())}")
        print(f"phase small_scenario_agreement ({dp_rng}): "
              f"far_messages={gpu['final']['far_messages']} "
              f"overflow_hwm={gpu['final']['overflow_hwm']} "
              f"losses card={lg.tolist()} cpu={lc.tolist()} "
              f"max_rel={float(np.max(np.abs(lg - lc) / np.abs(lc)))} "
              f"model_max_abs={float(np.abs(mg - mc).max())} wall_s={wall}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.cohort import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase build: {sorted(logs)} built in "
          f"{time.perf_counter() - t0} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
    dev = resolve_device(None)

    t0 = time.perf_counter()
    kernels = phase_kernels(dev)
    print(f"phase kernels: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_census(dev)
    print(f"phase census: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    X, y, kw = main_inputs()
    print(f"phase main: setup_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    counts = phase_main(dev, X, y, kw)
    print(f"phase main: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    scn_counts = phase_scenarios(dev, X, y, kw)
    print(f"phase scenarios: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_small_scenario(dev)
    print(f"phase small_scenario_agreement: wall_s="
          f"{time.perf_counter() - t0}")
    # launches: the main run's for the main path's kernels, the scenario
    # runs' for the in-kernel noise (the path that runs it)
    for k in kernels:
        k["launches"] = (scn_counts[k["name"]]
                         if k["name"] == "cohort_clip_noise_prng"
                         else counts[k["name"]])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
