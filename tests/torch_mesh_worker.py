"""One rank of the device cohort engine over a ``clients`` mesh, on the CPU.

    python tests/torch_mesh_worker.py --rank R --world P --store DIR \\
        --out DIR [CASE ...]

Joins a gloo process group of ``P`` ranks through a ``file://`` store in
``DIR`` (no port to race for), builds ``cohort_mesh("cpu")`` and runs each
case through ``make_simulator("device", ..., mesh=mesh, device="cpu")``.
Rank 0 writes one pickle per case under ``--out`` with ``run_case``'s
record; every rank checks the state's placements against
``cohort_shardings`` and takes part in the gathers.  Imports torch, numpy
and ``repro_torch`` only (no jax): ``tests/test_torch_cohort_mesh.py``
starts it and compares the records.

``CASES`` and ``run_case`` are also what the test runs in its own process
with ``mesh=None``.
"""
import argparse
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

_DP_TASK = dict(l2=1.0 / 300, sample_seed=21, dp_clip=0.1, dp_sigma=8.0)
_BASE = dict(data=(300, 8, 9), task=_DP_TASK,
             sim=dict(n_clients=20, sizes_per_client=[4, 6, 8],
                      round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2,
                      block=4, dp_round_clip=1.0),
             rounds=3, eval_every=1)


def _with(cfg, **sim):
    return dict(cfg, sim=dict(cfg["sim"], **sim))


#: name -> config (data, task and simulator keywords, rounds); a
#: scenario is a preset name or (preset, ring_cap)
CASES = {
    # the paper's strategy with DP, operand noise and the in-kernel
    # stream's twin (20 clients: blocks of 4 straddle ranks at 2 and 4)
    "paper_dp": _BASE,
    "paper_dp_in_kernel": _with(_BASE, dp_rng="in_kernel"),
    "fedasync_mobile_diurnal_dp": _with(_BASE, scenario="mobile_diurnal",
                                        strategy="fedasync"),
    # ring of 2 ticks at block 1: the straggler tail routes through the
    # far tier
    "fedbuff4_iot_straggler_ring2": _with(
        _BASE, scenario=("iot_straggler", 2), block=1,
        strategy={"kind": "fedbuff", "buffer_size": 4}),
    "geo_regional_unfused": _with(_BASE, scenario="geo_regional",
                                  fuse_ticks=False),
    # 1160 clients: blocks of 8 rows, 290 rows a rank at 4 ranks (580 at
    # 2), so blocks straddle rank boundaries
    "split_block_C1160": dict(
        data=(400, 4, 3), task=dict(l2=1.0 / 400, sample_seed=5,
                                    dp_clip=0.1, dp_sigma=2.0),
        sim=dict(n_clients=1160, sizes_per_client=[4, 6],
                 round_stepsizes=[0.1, 0.08], d=1, seed=4, block=4,
                 dp_round_clip=0.5, scenario="mobile_diurnal"),
        rounds=2, eval_every=1),
    # 6 clients: cut in 3s at 2 ranks, replicated at 4 (6 % 4 != 0)
    "replicated_C6": _with(dict(_BASE, sim=dict(_BASE["sim"], n_clients=6)),
                           scenario="iot_straggler"),
}


def scenario_of(spec, module):
    """A case's scenario through ``module`` (``repro_torch.scenarios`` or
    the reference's): a preset name, or (preset, ring_cap)."""
    if isinstance(spec, tuple):
        name, cap = spec
        return dataclasses.replace(module.get_scenario(name), ring_cap=cap)
    return spec


def sim_kwargs(cfg, module):
    kw = dict(cfg["sim"])
    if "scenario" in kw:
        kw["scenario"] = scenario_of(kw["scenario"], module)
    return kw


def run_case(name, mesh, tick_log=None, trace=None):
    """Run case ``name`` on the CPU over ``mesh`` (None: one device) ->
    the record the test compares: integers, losses, the model, the DP
    rows, the whole state (gathered), the placements seen.  ``trace``:
    the engine's JSONL ``trace=`` path."""
    import repro_torch as rt
    from repro_torch import scenarios as tscn

    cfg = CASES[name]
    n, d, seed = cfg["data"]
    X, y = rt.make_binary_dataset(n, d, seed=seed, noise=0.3)
    sim = rt.make_simulator("device", rt.LogRegTask(X, y, **cfg["task"]),
                            **sim_kwargs(cfg, tscn), device="cpu",
                            mesh=mesh, trace=trace)
    eng = sim.engine
    if tick_log is not None:
        tick = eng._tick

        def logged(st, t, sk0):
            before = dict(eng.collectives)
            st, p = tick(st, t, sk0)
            tick_log.append((bool(p.any_done), {
                k: eng.collectives[k] - before[k] for k in before}))
            return st, p

        eng._tick = logged
    res = sim.run(max_rounds=cfg["rounds"], eval_every=cfg["eval_every"])
    tel = res["telemetry"]
    st = eng.state
    whole, placed = {}, {}
    for f in st._fields:
        t = getattr(st, f)
        if hasattr(t, "full_tensor"):
            placed[f] = [repr(p) for p in t.placements]
            t = t.full_tensor()
        whole[f] = t.numpy().copy()
    return {
        "ints": {
            "rounds": int(res["final"]["round"]),
            "messages": int(res["final"]["messages"]),
            "broadcasts": int(res["final"]["broadcasts"]),
            "overflow_hwm": int(res["final"]["overflow_hwm"]),
            "overflow_slots": int(res["final"]["overflow_slots"]),
            "far_messages": int(res["final"]["far_messages"]),
            "participation": [int(x) for x in tel.participation],
            "bytes_up": int(tel.bytes_up.sum()),
            "staleness_hist": [int(x) for x in tel.staleness_hist],
            "ops": dict(tel.ops),
            "ticks": int(tel.ticks),
            "fused_iters": tuple(eng.fused_iters),
        },
        "losses": [float(h["loss"]) for h in res["history"]]
        + [float(res["final"]["loss"])],
        "history": [dict(h) for h in res["history"]],
        "model": np.concatenate([res["model"]["w"].numpy().ravel(),
                                 res["model"]["b"].numpy().reshape(1)]),
        "dp": tel.dp,
        "state": whole,
        "placements": placed,
        "host_syncs": dict(eng.host_syncs),
        "collectives": dict(eng.collectives),
        "sharded": eng.axis.sharded,
        "F": eng.F,
    }


def _expected_placements(mesh, C):
    from repro_torch.sharding import cohort_shardings
    return {f: [repr(p) for p in pl]
            for f, (_, pl) in cohort_shardings(mesh, C).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("cases", nargs="*", default=sorted(CASES))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.sharding import cohort_mesh
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(args.store, "store"),
        rank=args.rank, world_size=args.world)
    try:
        mesh = cohort_mesh("cpu")
        for name in args.cases:
            log = []
            # each rank names its own trace file: only rank 0's is written
            trace = os.path.join(args.out, f"{name}.rank{args.rank}.jsonl")
            rec = run_case(name, mesh, tick_log=log, trace=trace)
            want = _expected_placements(mesh, CASES[name]["sim"]
                                        ["n_clients"])
            if rec["placements"] != want:
                raise AssertionError(f"{name}: placements "
                                     f"{rec['placements']} != {want}")
            rec["tick_log"] = log
            if args.rank == 0:
                with open(os.path.join(args.out, f"{name}.pkl"), "wb") as f:
                    pickle.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
