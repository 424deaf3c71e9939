#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

1. every kernel against its plain PyTorch version at the shapes of the
   main run (bitwise where the kernel keeps the plain version's
   rounding, within a stated tolerance where it reorders a sum), twice
   for identical bits, with its median time (CUDA graph of launches,
   CUDA events), its memory bound and the plain version's time;
2. the FedSGD census case (C = 4096), whose integer op census must
   reproduce the reference's, and a small DP case that must agree with
   the port's plain CPU run;
3. the main run: the paper's DP configuration (Fig. 1b sizes and step
   sizes, sigma = 8, clip 0.1) on MNIST-width logistic regression
   (D = 785) over C = 16384 clients, with every kernel's launch count.

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

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the main run: paper_logreg at its source's widest width (MNIST, 784
# features) with Fig. 1b's DP protocol
MAIN = dict(n=60_000, d=784, C=16_384, d_gate=2, rounds=8, block=64,
            seed=0)
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


def bound(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def phase_kernels(dev):
    """Phase 1: each kernel against its plain version at the main run's
    shapes; returns the kernels' JSON entries (launches filled later)."""
    import torch
    from repro_torch.kernels.cohort_dp import cohort_clip_noise
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
    return out


def run_sim(dev, X, y, *, C, sizes, etas, d, seed, block, rounds,
            eval_every, l2, dp_clip=0.0, dp_sigma=0.0, dp_round_clip=0.0,
            sample_seed=0):
    import torch
    import repro_torch as rt
    task = rt.LogRegTask(X, y, l2=l2, dp_clip=dp_clip, dp_sigma=dp_sigma,
                         sample_seed=sample_seed)
    sim = rt.DeviceCohortSimulator(
        task, n_clients=C, sizes_per_client=sizes, round_stepsizes=etas,
        d=d, seed=seed, block=block, dp_round_clip=dp_round_clip,
        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(max_rounds=rounds, eval_every=eval_every)
    wall = time.perf_counter() - t0
    return sim, res, wall


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


def phase_main(dev):
    """Phase 3: the main run, with the kernels' launch counts."""
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.core.sequences import sample_sizes
    from repro_torch.core.stepsizes import round_stepsizes
    from repro_torch.kernels import launches
    from repro_torch.telemetry import check_ops

    cfg = fl_config_fig1b()
    m = MAIN
    t0 = time.perf_counter()
    X, y = rt.make_binary_dataset(m["n"], m["d"], seed=m["seed"], noise=0.3)
    sizes = sample_sizes(cfg.sample_seq, m["rounds"] + m["d_gate"] + 1)
    etas = round_stepsizes(cfg.step_size, sizes)
    setup = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    sim, res, wall = run_sim(
        dev, X, y, C=m["C"], sizes=sizes, etas=etas, d=m["d_gate"],
        seed=m["seed"], block=m["block"], rounds=m["rounds"],
        eval_every=m["rounds"] // 2, l2=1.0 / m["n"],
        dp_clip=cfg.dp.clip_norm, dp_sigma=cfg.dp.sigma)
    counts = dict(launches.LAUNCHES)
    tel = res["telemetry"]
    eng = sim.engine
    if res["final"]["round"] < m["rounds"]:
        fail(f"main run reached round {res['final']['round']}")
    probs = check_ops(tel.ops, messages=tel.messages,
                      broadcasts=tel.broadcasts,
                      far_messages=tel.far_messages, clients=m["C"],
                      ticks=tel.ticks, loop_iters=eng.fused_iters[0],
                      block_iters=eng.fused_iters[1])
    if probs:
        fail(f"main run op census: {probs}")
    losses = [h["loss"] for h in res["history"]] + [res["final"]["loss"]]
    if not all(math.isfinite(x) for x in losses):
        fail(f"main run losses not finite: {losses}")
    v = res["model"]["w"]
    if tuple(v.shape) != (m["d"],) or not bool(torch.isfinite(v).all()):
        fail("main run model has the wrong shape or is not finite")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main run")
    ticks = tel.ticks
    print(f"phase main: C={m['C']} D={m['d'] + 1} rounds={m['rounds']} "
          f"sizes={sizes} ticks={ticks} ops={tel.ops} "
          f"fused_iters={eng.fused_iters} host_syncs={eng.host_syncs} "
          f"losses={losses} wall_s={wall} setup_s={setup} "
          f"client_rounds_per_s={m['C'] * m['rounds'] / wall} "
          f"ms_per_tick={1e3 * wall / ticks} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9} "
          f"wall_phases={tel.wall} launches={counts}")
    eps = [r["epsilon"] for r in (tel.dp or []) if r["epsilon"] is not None]
    print(f"phase main: dp rows={len(tel.dp or [])} "
          f"max_epsilon={max(eps) if eps else None}")
    return counts


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
    counts = phase_main(dev)
    for k in kernels:
        k["launches"] = counts[k["name"]]
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
