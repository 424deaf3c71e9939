#!/usr/bin/env python3
"""End-to-end walls of the port's cohort runs on one NVIDIA GPU.

    python3 chip_walls.py [TREE] [LABEL]

Runs, from the checkout at TREE (default: this one), the main run of
``chip_smoke.py`` (C = 16384, D = 785, DP on) with operand and with
in-kernel noise, twice each, then the two scenario runs with in-kernel
noise, and prints one ``walls LABEL ...`` line per run: the wall, ms
per tick, and the CUDA-event spans of the round-completion noise calls
(sum, median, first, max).  Then the DP round of ``chip_smoke.py``
(``dp_sgd_round`` over the main data), whole and in its microbatches,
three calls each (the first carries the one-time set-up).  Last, the
device-engine runs of ``chip_smoke.py`` phase 13 (b) (mamba2-780m at
``TRAIN_COHORT``'s depth, C 2, three rounds), without DP and with
in-kernel noise, three times each.  The spans include any time the card
waits for the host inside the call.  To compare two commits, unpack the other
one into a directory that ``.gitignore`` lists and run both in one call,
in turns (parent, change, change, parent); each run is its own process.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import sys
import time


def spans(eng):
    """CUDA events around each ``_clip_noise`` call; returns a function
    giving their spans in ms."""
    import torch
    out = []
    inner = eng._clip_noise

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = inner(*a, **k)
        e1.record()
        out.append((e0, e1))
        return res

    eng._clip_noise = timed
    return lambda: [a.elapsed_time(b) for a, b in out]


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.abspath(__file__)))
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("chip_walls: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import repro_torch as rt
    from repro_torch import _build
    from repro_torch.scenarios import get_scenario

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all(["tick_fused", "cohort_dp", "dp_clip", "ssd_scan"])
    dev = torch.device("cuda")
    X, y, kw = cs.main_inputs()

    def run(what, block, rounds, eval_every, **extra):
        sim = cs.make_sim(dev, X, y, block=block, **kw, **extra)
        get = spans(sim.engine)
        res, wall = cs.timed_run(sim, rounds, eval_every)
        s, ticks = get(), res["telemetry"].ticks
        print(f"walls {label} {what}: wall_s={wall} ticks={ticks} "
              f"ms_per_tick={1e3 * wall / ticks} noise_calls={len(s)} "
              f"noise_ms_sum={sum(s)} "
              f"noise_ms_median={statistics.median(s) if s else 0.0} "
              f"noise_ms_first={s[0] if s else 0.0} "
              f"noise_ms_max={max(s) if s else 0.0}", flush=True)

    m = cs.MAIN
    for rep in range(2):
        for dp_rng in ("operand", "in_kernel"):
            run(f"main {dp_rng} rep{rep}", m["block"], m["rounds"],
                m["rounds"] // 2, dp_rng=dp_rng)
    for sc in cs.SCENARIOS:
        scn = get_scenario(sc["scenario"])
        if sc["ring_cap"] is not None:
            scn = dataclasses.replace(scn, ring_cap=sc["ring_cap"])
        kind, hp = sc["strategy"]
        strat = (rt.core.FedAsyncStrategy(**hp) if kind == "fedasync"
                 else rt.core.FedBuffStrategy(**hp))
        run(f"{sc['tag']} in_kernel", sc["block"], sc["rounds"],
            sc["rounds"], scenario=scn, strategy=strat, dp_rng="in_kernel")

    from repro_torch import prng
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.dp import dp_sgd_round
    from repro_torch.models import logreg
    dp = fl_config_fig1b().dp
    params = logreg.init_params(X.shape[1], prng.PRNGKey(0), device=dev)
    batch = (torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev))

    def loss_fn(p, ex):
        return logreg.per_example_loss(p, ex[0], ex[1])
    for mb in (0, cs.DP_MICROBATCH):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp_sgd_round(loss_fn, params, batch, clip_norm=dp.clip_norm,
                         sigma=dp.sigma, rng=prng.PRNGKey(m["seed"]),
                         microbatch=mb)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"walls {label} dp_round microbatch={mb}: walls_s={walls}",
              flush=True)
    del batch, params
    model_cohort_walls(cs, dev, label)
    return 0


def model_cohort_walls(cs, dev, label: str) -> None:
    """Phase 13 (b)'s device-engine runs, three times each."""
    import torch
    import repro_torch as rt
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    from repro_torch.models import init_params
    tc = cs.TRAIN_COHORT
    cfg = get_config(tc["arch"])
    # the depth phase 13 (b) runs where its full depth does not fit the
    # card (``layers`` in trees before the cut was tried first)
    layers = tc.get("cut_layers", tc.get("layers"))
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = init_params(cfg, prng.PRNGKey(tc["seed"]), torch.float32,
                         device=dev)
    batcher = SeedAddressedBatcher(cfg, batch_size=tc["B"], seq_len=tc["S"],
                                   seed=tc["seed"], device=dev)
    kw = dict(n_clients=tc["C"], sizes_per_client=tc["sizes"],
              round_stepsizes=tc["etas"], d=tc["d"], seed=tc["seed"],
              speeds=tc["speeds"], device=dev)
    for rep in range(3):
        for dp, rng in ((False, "operand"), (True, "in_kernel")):
            task = BatchModelTask(cfg, params, batcher,
                                  dp_clip=tc["clip"] if dp else 0.0,
                                  dp_sigma=tc["sigma"] if dp else 0.0)
            sim = rt.DeviceCohortSimulator(task, latency=tc["latency"],
                                           block=tc["block"], dp_rng=rng,
                                           **kw)
            res, wall = cs.timed_run(sim, tc["rounds"], 1)
            print(f"walls {label} model_cohort device dp={dp} {rng} "
                  f"rep{rep}: wall_s={wall} "
                  f"ticks={res['telemetry'].ticks}", flush=True)
            del sim, res, task
            torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
