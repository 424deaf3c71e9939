"""The device cohort engine over a ``clients`` mesh on the CPU: gloo
process groups of 1, 2 and 4 ranks (``tests/torch_mesh_worker.py``, one
spawn per world size running every case, the store a ``file://`` in
``tmp_path``), each case's result bit for bit the ``mesh=None`` run's and
within the reference's tolerance of the live JAX engine.

Cases (``torch_mesh_worker.CASES``): the paper's strategy with DP and
operand noise, and with the in-kernel stream's twin; FedAsync under
``mobile_diurnal``; FedBuff(4) under ``iot_straggler`` with a ring of 2
ticks (the far tier used); ``geo_regional`` unfused; C 1160 (blocks of 8
rows straddle the ranks' boundaries at 2 and 4 ranks); C 6 (cut at 2
ranks, replicated at 4).  Bit for bit: every integer, the census, the
loop-iteration census, the losses, the DP rows, the model and every
field of the state, gathered from the ranks.  Against the reference:
integers exact, floats rtol 1e-5 / atol 1e-7 (the in-kernel stream has
no CPU counterpart in the reference: its integers are held to the
reference's operand run, whose protocol they share).  Also the state's
placements (``cohort_shardings``), one host read a tick, the
collectives a tick, and the trace written by rank 0 alone.

The children are started with a hard deadline and killed past it, so a
hang fails here with a message instead of holding the whole suite.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_worker as worker  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
WORLDS = (1, 2, 4)
DEADLINE_S = 240
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{world size: {case: rank 0's record}} from one spawn of each world
    size, all started at once; the parent runs the one-device engine
    meanwhile (``one_device``)."""
    root = tmp_path_factory.mktemp("cohort_mesh")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {}
    for P in WORLDS:
        store, out = root / f"store{P}", root / f"out{P}"
        store.mkdir()
        out.mkdir()
        procs[P] = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"),
             "--rank", str(r), "--world", str(P), "--store", str(store),
             "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(P)]
    return root, procs


def _join(root, procs):
    t_end = time.monotonic() + DEADLINE_S
    failed = []
    for P, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                out, _ = p.communicate(timeout=max(1.0,
                                                   t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in (q for qs in procs.values() for q in qs):
                    q.kill()
                pytest.fail(f"world {P} rank {r} still running after "
                            f"{DEADLINE_S} s: killed (a hang in the "
                            f"sharded tick's collectives?)")
            if p.returncode != 0:
                failed.append(f"world {P} rank {r} exited "
                              f"{p.returncode}:\n{out.decode()[-3000:]}")
    if failed:
        pytest.fail("\n".join(failed))
    runs = {}
    for P in procs:
        runs[P] = {}
        for name in worker.CASES:
            with open(root / f"out{P}" / f"{name}.pkl", "rb") as f:
                runs[P][name] = pickle.load(f)
    return runs


@pytest.fixture(scope="module")
def one_device(mesh_runs, reference):
    """(the parent's runs with ``mesh=None``, the children's records
    joined after the parent's own work, the children's directory)."""
    import torch
    torch.set_num_threads(2)
    base = {name: worker.run_case(name, None) for name in worker.CASES}
    return base, _join(*mesh_runs), mesh_runs[0]


@pytest.fixture(scope="module")
def reference():
    """The live JAX engine on each case (operand noise)."""
    from repro import scenarios as jscn
    from repro.cohort import DeviceCohortSimulator as JaxSimulator
    from repro.core import LogRegTask as JaxLogRegTask
    from repro_torch.data import make_binary_dataset

    out = {}
    for name, cfg in worker.CASES.items():
        kw = worker.sim_kwargs(cfg, jscn)
        kw.pop("dp_rng", None)
        n, d, seed = cfg["data"]
        X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
        sim = JaxSimulator(JaxLogRegTask(X, y, **cfg["task"]), **kw)
        res = sim.run(max_rounds=cfg["rounds"],
                      eval_every=cfg["eval_every"])
        tel = res["telemetry"]
        out[name] = {
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
                "fused_iters": tuple(sim.engine.fused_iters),
            },
            "losses": [float(h["loss"]) for h in res["history"]]
            + [float(res["final"]["loss"])],
            "model": np.concatenate([
                np.asarray(res["model"]["w"]).ravel(),
                np.asarray(res["model"]["b"]).reshape(1)]),
            "dp": tel.dp,
        }
    return out


def _bits(x) -> bytes:
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("case", sorted(worker.CASES))
def test_mesh_run_is_the_one_device_run_bit_for_bit(one_device, case, P):
    base, runs, _ = one_device
    got, want = runs[P][case], base[case]
    assert got["ints"] == want["ints"]
    assert _bits(got["losses"]) == _bits(want["losses"])
    assert _bits(got["model"]) == _bits(want["model"])
    assert got["dp"] == want["dp"]
    assert got["history"] == want["history"]
    assert sorted(got["state"]) == sorted(want["state"])
    for f, a in want["state"].items():
        b = got["state"][f]
        assert b.shape == a.shape and b.dtype == a.dtype, f
        assert _bits(b) == _bits(a), f"state field {f} differs"


@pytest.mark.parametrize("case", sorted(worker.CASES))
def test_mesh_run_meets_the_reference(one_device, reference, case):
    _, runs, _ = one_device
    want = reference[case]
    for P in WORLDS:
        got = runs[P][case]
        assert got["ints"] == want["ints"], P
        if worker.CASES[case]["sim"].get("dp_rng") == "in_kernel":
            continue
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                                   atol=ATOL)
        assert got["dp"] == want["dp"]


@pytest.mark.parametrize("P", WORLDS)
def test_state_placements_are_cohort_shardings(one_device, P):
    from repro_torch.sharding import MeshShape, cohort_shardings
    _, runs, _ = one_device
    mesh = MeshShape(("clients",), (P,))
    for case, cfg in worker.CASES.items():
        want = {f: [repr(p) for p in pl] for f, (_, pl) in
                cohort_shardings(mesh, cfg["sim"]["n_clients"]).items()}
        assert runs[P][case]["placements"] == want, case


@pytest.mark.parametrize("P", WORLDS)
def test_one_host_read_and_few_collectives_a_tick(one_device, P):
    _, runs, _ = one_device
    for case, rec in runs[P].items():
        assert rec["host_syncs"]["tick"] == rec["ints"]["ticks"], case
        for done, counts in rec["tick_log"]:
            n = sum(counts.values())
            if done:
                assert n <= 3 and counts["allreduce"] <= 1, (case, counts)
            else:
                assert n <= 1 and counts["allreduce"] <= 1, (case, counts)
        if not rec["sharded"]:
            assert sum(rec["collectives"].values()) == 0, case


def test_the_cases_cut_and_replicate_as_meant(one_device):
    """The far tier carries traffic; C 1160 passes carries at 2 and 4
    ranks; C 6 is cut at 2 ranks and replicated at 4; one rank cuts
    nothing."""
    _, runs, _ = one_device
    far = runs[4]["fedbuff4_iot_straggler_ring2"]
    assert far["F"] > 0 and far["ints"]["far_messages"] > 0
    for P in (2, 4):
        rec = runs[P]["split_block_C1160"]
        assert rec["sharded"] and rec["collectives"]["carry"] > 0
    assert runs[2]["replicated_C6"]["sharded"]
    assert not runs[4]["replicated_C6"]["sharded"]
    assert not any(rec["sharded"] for rec in runs[1].values())


@pytest.mark.parametrize("P", WORLDS)
def test_only_rank_0_writes_the_trace(one_device, P):
    """Every rank passes ``trace=`` a path of its own: rank 0's file holds
    the segments and the report (its census gathered from every rank),
    no other rank writes one, on a cut axis and a replicated one."""
    import json
    base, _, root = one_device
    for case in worker.CASES:
        path = root / f"out{P}" / f"{case}.rank0.jsonl"
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        kinds = [r["kind"] for r in recs]
        assert kinds.count("report") == 1 and "segment" in kinds, case
        report = recs[kinds.index("report")]
        assert (report["participation"]
                == base[case]["ints"]["participation"]), case
        for r in range(1, P):
            assert not (root / f"out{P}" / f"{case}.rank{r}.jsonl").exists()
