#!/usr/bin/env python3
"""Profile the port's main run on one NVIDIA GPU.

    python3 chip_profile.py [--rounds N]

Runs the main configuration of ``chip_smoke.py`` (Fig. 1b DP protocol,
D = 785, C = 16384) once to warm up (kernel build, allocator), then
again under ``torch.profiler`` and prints:

* the wall time of the run, its ticks and its host reads;
* device time by kernel (``key_averages``, top rows by device time) and
  the device busy share of the run's wall time;
* the same run's phases (integer tick phase, SGD block, DP noise draw,
  the fused kernels, the server's step among them) as host-timed spans
  closed by a device sync, so each span's time includes the device work
  it enqueued.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))


def build_run(rounds: int):
    import repro_torch as rt
    from chip_smoke import MAIN
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.core.sequences import sample_sizes
    from repro_torch.core.stepsizes import round_stepsizes

    cfg = fl_config_fig1b()
    m = dict(MAIN, rounds=rounds)
    X, y = rt.make_binary_dataset(m["n"], m["d"], seed=m["seed"], noise=0.3)
    sizes = sample_sizes(cfg.sample_seq, m["rounds"] + m["d_gate"] + 1)
    etas = round_stepsizes(cfg.step_size, sizes)

    def make():
        task = rt.LogRegTask(X, y, l2=1.0 / m["n"], dp_clip=cfg.dp.clip_norm,
                             dp_sigma=cfg.dp.sigma, sample_seed=0)
        return rt.DeviceCohortSimulator(
            task, n_clients=m["C"], sizes_per_client=sizes,
            round_stepsizes=etas, d=m["d_gate"], seed=m["seed"],
            block=m["block"], device="cuda")
    return make, m


def spans(make, rounds):
    """Host spans around the tick's parts, each closed by a device sync."""
    import torch
    from repro_torch import prng
    from repro_torch.cohort import clients as cmod
    from repro_torch.cohort import device as dmod

    sim = make()
    eng = sim.engine
    acc = {}

    def timed(name, fn):
        def wrap(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrap

    # the device module's names, and the rows pass the client axis calls
    wrapped = ("server_apply", "tick_deliver", "tick_scatter_finish",
               "cohort_clip_noise")
    orig = dict(normal_rows=prng.normal_rows,
                run_block=eng.ltask.run_block,
                tick_scatter_rows=cmod.tick_scatter_rows,
                **{k: getattr(dmod, k) for k in wrapped})
    try:
        dmod.prng.normal_rows = timed("dp_noise_draw", orig["normal_rows"])
        eng.ltask.run_block = timed("sgd_block", orig["run_block"])
        cmod.tick_scatter_rows = timed("tick_scatter_rows",
                                       orig["tick_scatter_rows"])
        for k in wrapped:
            setattr(dmod, k, timed(k, orig[k]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim.run(max_rounds=rounds, eval_every=rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dmod.prng.normal_rows = orig["normal_rows"]
        cmod.tick_scatter_rows = orig["tick_scatter_rows"]
        for k in wrapped:
            setattr(dmod, k, orig[k])
    return wall, acc, res, eng


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import _build

    _build.build_all()
    make, m = build_run(args.rounds)
    print(torch.cuda.get_device_name(0))
    make().run(max_rounds=args.rounds, eval_every=args.rounds)   # warm-up
    torch.cuda.synchronize()

    sim = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = sim.run(max_rounds=args.rounds, eval_every=args.rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tel = res["telemetry"]
    seg_s = sum(v for k, v in tel.wall.items()
                if k in ("first_segment_s", "steady_s"))
    print(f"profiled run: C={m['C']} rounds={args.rounds} ticks={tel.ticks} "
          f"wall_s={wall} segments_s={seg_s} (under the profiler) "
          f"host_syncs={sim.engine.host_syncs} wall_phases={tel.wall}")
    ka = prof.key_averages()
    sort_key = ("self_device_time_total"
                if hasattr(ka[0], "self_device_time_total")
                else "self_cuda_time_total")
    print(ka.table(sort_by=sort_key, row_limit=30))
    # kernel rows (device events) carry the device time once each
    kernel_us = sum(getattr(e, sort_key) for e in ka
                    if "CUDA" in str(getattr(e, "device_type", "")))
    print(f"device self time, all kernels: {kernel_us / 1e3} ms; of the "
          f"tick loop's {seg_s * 1e3} ms under the profiler -> busy share "
          f"{kernel_us / 1e6 / seg_s}")

    wall2, acc, res2, eng = spans(make, args.rounds)
    tel2 = res2["telemetry"]
    print(f"span run: wall_s={wall2} ticks={tel2.ticks} "
          f"wall_phases={tel2.wall}")
    for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  span {k}: {v * 1e3} ms ({100 * v / wall2:.1f}% of wall)")
    loop = sum(v for k, v in tel2.wall.items()
               if k in ("first_segment_s", "steady_s"))
    rest = loop - sum(acc.values())
    print(f"  span integer phase and host (tick loop minus spans): "
          f"{rest * 1e3} ms ({100 * rest / wall2:.1f}% of wall)")
    outside = wall2 - loop
    print(f"  outside the tick loop (eval, telemetry report incl. DP "
          f"accounting of every client): {outside * 1e3} ms "
          f"({100 * outside / wall2:.1f}% of wall)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
