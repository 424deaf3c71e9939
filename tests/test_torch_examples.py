"""The ported examples (``examples/torch_*.py``) at cut sizes on the CPU,
each ``main(argv)``'s numbers held against the same calls through the
reference package (``repro``) on the same seeds and sizes: integers
exact (rounds, messages, the accountant's round counts), losses within
the engine's own tolerance (1e-5 for the cohort engines, 1e-4 for the
event simulator), accuracies exact as counts of correct predictions (the
two packages' f32 means of one count may differ in the last place).  The
event simulator's logistic regression starts from the reference's initial
weights (the port's own draw is a few ulp off), as
``tests/test_torch_event_sim.py`` does.
"""
import importlib.util
import math
import os

import jax
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
COHORT_RTOL, EVENT_RTOL = 1e-5, 1e-4


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def reference_w0(monkeypatch):
    """The port's logistic-regression init returns the reference's draw."""
    from repro.models import logreg as jlogreg
    from repro_torch.models import logreg

    def init_params(d_features, key=None, device=None):
        p = jlogreg.init_params(d_features)
        return {k: torch.tensor(np.asarray(v), device=device)
                for k, v in p.items()}

    monkeypatch.setattr(logreg, "init_params", init_params)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def _same_count(got, want, n):
    """Accuracies over ``n`` examples: the same count of correct ones."""
    assert np.array_equal(np.rint(np.asarray(got, np.float64) * n),
                          np.rint(np.asarray(want, np.float64) * n))


def test_quickstart(reference_w0, capsys):
    from repro.configs.base import SampleSequenceConfig, StepSizeConfig
    from repro.core import (AsyncFLSimulator, LogRegTask, round_stepsizes,
                            rounds_for_budget, run_sync_baseline)
    from repro.data import make_binary_dataset
    n, K = 400, 800
    got = _example("quickstart").main(["--device", "cpu", "--n", str(n),
                                       "--budget", str(K)])
    assert "[async, increasing]" in capsys.readouterr().out
    X, y = make_binary_dataset(n=n, d=32, seed=0, noise=0.3)
    task = LogRegTask(X, y, l2=1.0 / len(X))
    sizes = rounds_for_budget(
        SampleSequenceConfig(kind="linear", s0=100, a=100.0), K)
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_t", eta0=0.1, beta=0.001), sizes)
    res = AsyncFLSimulator(
        task, n_clients=5,
        sizes_per_client=[[max(1, s // 5) for s in sizes]] * 5,
        round_stepsizes=etas, d=1, seed=0,
        speeds=[1.0, 0.8, 1.2, 0.9, 1.1]).run(max_rounds=len(sizes))
    const = run_sync_baseline(task, n_clients=5, n_rounds=K // 400,
                              sample_size=400 // 5, eta=0.0025)
    assert got["rounds"] == res["final"]["round"]
    assert got["messages"] == res["final"]["messages"]
    assert got["sync_rounds"] == const["final"]["round"]
    _same_count(got["accuracy"], float(res["final"]["accuracy"]), n)
    _same_count(got["sync_accuracy"], float(const["final"]["accuracy"]), n)
    _close(got["loss"], float(res["final"]["loss"]), EVENT_RTOL)
    _close(got["sync_loss"], float(const["final"]["loss"]), EVENT_RTOL)


def test_dp_federated(reference_w0):
    from repro.configs.base import StepSizeConfig
    from repro.core import AsyncFLSimulator, LogRegTask, round_stepsizes
    from repro.data import make_binary_dataset
    from repro.dp import select_parameters
    n, R = 800, 12
    got = _example("dp_federated").main(["--device", "cpu", "--n", str(n),
                                         "--max-rounds", str(R)])
    sel = select_parameters(s0c=16, N_c=10_000, p=1.0, epsilon=1.0,
                            sigma=8.0, K=25_000, r0=1.0 / math.e)
    assert (got["T"], got["T_constant"]) == (sel.T, sel.T_constant)
    assert (got["sigma"], got["epsilon"], got["delta"]) == (
        float(sel.sigma), float(sel.epsilon), float(sel.delta))
    assert got["aggregated_noise"] == float(sel.aggregated_noise)
    X, y = make_binary_dataset(n, 16, seed=2, noise=0.3)
    task = LogRegTask(X, y, l2=1.0 / len(X), dp_clip=0.1, dp_sigma=sel.sigma)
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_t", eta0=0.15, beta=0.001), sel.sizes)
    res = AsyncFLSimulator(
        task, n_clients=5,
        sizes_per_client=[[max(1, s // 5) for s in sel.sizes]] * 5,
        round_stepsizes=etas, d=1, seed=0).run(
            max_rounds=min(len(sel.sizes), R))
    assert got["rounds"] == res["final"]["round"] == R
    assert got["messages"] == res["final"]["messages"]
    _same_count(got["accuracy"], float(res["final"]["accuracy"]), n)
    _close(got["loss"], float(res["final"]["loss"]), EVENT_RTOL)


def test_biased_clients(reference_w0):
    from repro.configs.base import SampleSequenceConfig, StepSizeConfig
    from repro.core import (AsyncFLSimulator, LogRegTask, round_stepsizes,
                            rounds_for_budget)
    from repro.data import biased_split, make_binary_dataset, unbiased_split
    n, K = 800, 1500
    got = _example("biased_clients").main(["--device", "cpu", "--n", str(n),
                                           "--budget", str(K)])
    X, y = make_binary_dataset(n, 16, seed=6, noise=0.3)
    want = []
    for shards in (unbiased_split(X, y, 2, seed=0),
                   biased_split(X, y, 2, bias=1.0, seed=0)):
        sizes = rounds_for_budget(
            SampleSequenceConfig(kind="linear", s0=100, a=100.0), K)
        etas = round_stepsizes(
            StepSizeConfig(kind="inv_t", eta0=0.01, beta=0.001), sizes)
        sim = AsyncFLSimulator(
            LogRegTask(X, y, l2=1.0 / len(X)), n_clients=2,
            sizes_per_client=[[max(1, s // 2) for s in sizes]] * 2,
            round_stepsizes=etas, d=1, seed=0)
        for c, (sx, sy) in enumerate(shards):
            sim.clients[c].task = LogRegTask(sx, sy, l2=1.0 / len(sx))
        want.append(sim.run(max_rounds=len(sizes))["final"])
    assert got["rounds"] == [int(f["round"]) for f in want]
    assert got["messages"] == [int(f["messages"]) for f in want]
    _same_count(got["accuracy"], [float(f["accuracy"]) for f in want], n)
    _close(got["loss"], [float(f["loss"]) for f in want], EVENT_RTOL)


def test_cohort_quickstart(reference_w0):
    from repro.cohort import make_simulator
    from repro.configs.base import FLConfig
    from repro.core import LogRegTask
    from repro.data import make_binary_dataset
    n, C, Cs = 400, 32, 16
    mod = _example("cohort_quickstart")
    got = mod.main(["--device", "cpu", "--n", str(n), "--clients", str(C),
                    "--scenario-clients", str(Cs), "--presets",
                    "iot_straggler"])
    X, y = make_binary_dataset(n=n, d=32, seed=0, noise=0.3)
    kw = dict(sizes_per_client=[16] * 3, round_stepsizes=[0.1, 0.08, 0.06],
              d=1, seed=0)

    def task():
        return LogRegTask(X, y, l2=1.0 / len(X), sample_seed=0)

    par = [make_simulator(FLConfig(engine=e, cohort_block=16), task(),
                          n_clients=8, **kw).run(max_rounds=3)
           for e in ("event", "cohort", "device")]
    assert got["parity"]["rounds"] == [int(r["final"]["round"]) for r in par]
    _close(got["parity"]["loss"][0], float(par[0]["final"]["loss"]),
           EVENT_RTOL)
    _close(got["parity"]["loss"][1:], [float(r["final"]["loss"])
                                       for r in par[1:]], COHORT_RTOL)
    assert got["parity"]["max_dw_device"] == 0.0
    for engine in ("cohort", "device"):
        res = make_simulator(FLConfig(engine=engine), task(), n_clients=C,
                             **kw).run(max_rounds=3)
        assert got[engine]["rounds"] == res["final"]["round"]
        assert got[engine]["messages"] == res["final"]["messages"]
        _same_count(got[engine]["accuracy"], float(res["final"]["accuracy"]),
                    n)
        _close(got[engine]["loss"], float(res["final"]["loss"]),
               COHORT_RTOL)
    assert sorted(got["scenarios"]) == ["iot_straggler", "two_pop_regional"]
    for preset in ("iot_straggler",):
        res = make_simulator(
            FLConfig(engine="device", cohort_block=16, scenario=preset),
            task(), n_clients=Cs, **kw).run(max_rounds=3)
        g = got["scenarios"][preset]
        assert (g["rounds"], g["messages"]) == (res["final"]["round"],
                                                res["final"]["messages"])
        assert g["time"] == float(res["final"]["time"])
        _close(g["loss"], float(res["final"]["loss"]), COHORT_RTOL)
    assert got["trace_records"] > 0


@pytest.mark.parametrize("engine", ["event", "device"])
def test_llm_fl_pretrain(engine):
    import jax.numpy as jnp
    from repro.cohort import make_simulator
    from repro.configs import get_config, reduced
    from repro.configs.base import StepSizeConfig
    from repro.core import BatchModelTask, round_stepsizes
    from repro.data import SeedAddressedBatcher
    from repro.models import init_params, train_loss
    argv = ["--device", "cpu", "--engine", engine, "--rounds", "2",
            "--layers", "2", "--d-model", "64", "--seq", "16", "--batch",
            "2"]
    got = _example("llm_fl_pretrain").main(argv)
    cfg = reduced(get_config("gemma-2b"), n_layers=2, d_model=64,
                  vocab=2048)
    params = init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    batcher = SeedAddressedBatcher(cfg, batch_size=2, seq_len=16, seed=0)
    task = BatchModelTask(cfg, params, batcher)
    sizes = [[1 + i for i in range(2)]] * 2
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_sqrt", eta0=0.1, beta=0.05), sizes[0])
    loss0 = float(train_loss(cfg, params, batcher(0, 0, 0)))
    res = make_simulator(engine, task, n_clients=2, sizes_per_client=sizes,
                         round_stepsizes=etas, d=1, seed=0,
                         speeds=[1.0, 1.2]).run(max_rounds=2)
    loss1 = float(train_loss(cfg, res["model"], batcher(0, 0, 0)))
    assert got["n_params"] == cfg.param_count()
    assert (got["rounds"], got["steps"], got["messages"]) == (
        res["final"]["round"], 6, res["final"]["messages"])
    rtol = EVENT_RTOL if engine == "event" else COHORT_RTOL
    _close([got["loss0"], got["loss1"]], [loss0, loss1], rtol)
