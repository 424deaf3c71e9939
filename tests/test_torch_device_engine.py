"""The whole slice: the port's DeviceCohortSimulator (on the CPU, i.e. on
the plain kernel versions) against the live JAX reference engine.

Cases: the golden ``uniform`` case and its DP variant, ``fedsgd_r8_s1``,
the other four golden pairings (``mobile_diurnal``, ``iot_straggler``,
``mobile_diurnal+fedasync``, ``iot_straggler+fedbuff``), ``geo_regional``,
``sensor_renewal`` and the overflow "tail" scenario (a latency tail past
the ring, so updates route through the overflow bucket) under each
strategy with DP on.

Integer fields — rounds, messages, broadcasts, participation, bytes,
the staleness histogram, the overflow high-water mark and far-tier
count, the op census and the loop-iteration census — are exact.  Losses
and the final model are held to the goldens' rtol 1e-5 / atol 1e-7.
The goldens' floats are not used: they were recorded on an older jax and
no longer reproduce; the reference is run live instead, and only the
goldens' integer fields serve as fixed anchors.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscn
from repro.cohort import DeviceCohortSimulator as JaxSimulator
from repro.core import LogRegTask as JaxLogRegTask
from repro_torch import (DeviceCohortSimulator, LogRegTask,
                         make_simulator)
from repro_torch import scenarios as tscn
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.data import make_binary_dataset

RTOL, ATOL = 1e-5, 1e-7

# the golden `uniform` case (tests/test_golden_trajectories.py)
GOLDEN = dict(data=(300, 12, 9), task=dict(l2=1.0 / 300, sample_seed=21),
              sim=dict(n_clients=6, sizes_per_client=[4, 6, 8],
                       round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2,
                       block=4, scenario="uniform"),
              rounds=3, eval_every=1)
GOLDEN_DP = dict(GOLDEN, task=dict(GOLDEN["task"], dp_clip=0.1,
                                   dp_sigma=8.0),
                 sim=dict(GOLDEN["sim"], dp_round_clip=1.0))
# fedsgd_r8_s1 of benchmarks/bench_cohort_scale.py at C = 64
FEDSGD = dict(data=(2048, 32, 0), task=dict(l2=1.0 / 2048, sample_seed=0),
              sim=dict(n_clients=64, sizes_per_client=[1] * 8,
                       round_stepsizes=[0.1] * 8, d=1, seed=0, block=64),
              rounds=8, eval_every=8)
# the overflow scenario of tests/test_scenarios.py
# (test_overflow_bucket_bounded_ring_and_parity): latency U(1, 200) s
# over a ring capped at 8 ticks, DP on; "scenario": "tail" is resolved
# per side by _scenario
TAIL = dict(data=(300, 12, 9),
            task=dict(l2=1.0 / 300, sample_seed=21, dp_clip=0.1,
                      dp_sigma=2.0),
            sim=dict(n_clients=6, sizes_per_client=[4, 6], d=2, seed=2,
                     round_stepsizes=[0.1, 0.08], block=4,
                     dp_round_clip=0.5, scenario="tail"),
            rounds=3, eval_every=1)


def _with(cfg, **sim):
    return dict(cfg, sim=dict(cfg["sim"], **sim))


CASES = {"golden_uniform": GOLDEN, "golden_uniform_dp": GOLDEN_DP,
         "fedsgd_r8_s1_C64": FEDSGD,
         "golden_mobile_diurnal": _with(GOLDEN, scenario="mobile_diurnal"),
         "golden_iot_straggler": _with(GOLDEN, scenario="iot_straggler"),
         "golden_mobile_diurnal+fedasync": _with(
             GOLDEN, scenario="mobile_diurnal", strategy="fedasync"),
         "golden_iot_straggler+fedbuff": _with(
             GOLDEN, scenario="iot_straggler",
             strategy={"kind": "fedbuff", "buffer_size": 3}),
         "geo_regional_dp": _with(GOLDEN_DP, scenario="geo_regional"),
         "sensor_renewal_dp": _with(GOLDEN_DP, scenario="sensor_renewal"),
         "tail_overflow_dp": TAIL,
         "tail_overflow_dp+fedasync": _with(TAIL, strategy="fedasync"),
         "tail_overflow_dp+fedbuff": _with(
             TAIL, strategy={"kind": "fedbuff", "buffer_size": 3})}


def _scenario(sim, jax_side):
    if sim.get("scenario") != "tail":
        return sim
    mod = jscn if jax_side else tscn
    return dict(sim, scenario=mod.Scenario(
        "tail", mod.LatencyTable.from_uniform(1.0, 200.0, 16), ring_cap=8))


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _run(cfg, jax_side: bool):
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    sim_kw = _scenario(cfg["sim"], jax_side)
    if jax_side:
        sim = JaxSimulator(JaxLogRegTask(X, y, **cfg["task"]), **sim_kw)
    else:
        sim = DeviceCohortSimulator(LogRegTask(X, y, **cfg["task"]),
                                    **sim_kw, device="cpu")
    res = sim.run(max_rounds=cfg["rounds"], eval_every=cfg["eval_every"])
    tel = res["telemetry"]
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
            "fused_iters": tuple(sim.engine.fused_iters),
        },
        "losses": [float(h["loss"]) for h in res["history"]]
        + [float(res["final"]["loss"])],
        "model": np.concatenate([_np(res["model"]["w"]).ravel(),
                                 _np(res["model"]["b"]).reshape(1)]),
        "dp": tel.dp,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_reference(case):
    want = _run(CASES[case], jax_side=True)
    got = _run(CASES[case], jax_side=False)
    assert got["ints"] == want["ints"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                               atol=ATOL)
    assert got["dp"] == want["dp"]


def _tick_by_tick(cfg, ticks):
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    jsim = JaxSimulator(JaxLogRegTask(X, y, **cfg["task"]),
                        **_scenario(cfg["sim"], True), fuse_ticks=False)
    tsim = DeviceCohortSimulator(LogRegTask(X, y, **cfg["task"]),
                                 **_scenario(cfg["sim"], False),
                                 fuse_ticks=False, device="cpu")
    je, te = jsim.engine, tsim.engine
    seg = je._segment_fn()
    st = je.state
    for t in range(1, ticks + 1):
        np_state = jax.tree_util.tree_map(np.asarray, st)
        te.state = state_from_jax(np_state)
        te.segment(target_k=99, tick_limit=t)
        st = seg(st, je._etas_dev, je._sizes_dev, je._accrual_dev,
                 jnp.int32(99), jnp.int32(t))
        for f in st._fields:
            a, b = np.asarray(getattr(st, f)), _np(getattr(te.state, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            if a.dtype == np.int32:
                assert np.array_equal(a, b), (t, f)
            else:
                np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                           err_msg=f"tick {t} field {f}")
    return st


GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden",
                           "golden_trajectories.json")
GOLDEN_KEYS = {"uniform": "golden_uniform",
               "mobile_diurnal": "golden_mobile_diurnal",
               "iot_straggler": "golden_iot_straggler",
               "mobile_diurnal+fedasync": "golden_mobile_diurnal+fedasync",
               "iot_straggler+fedbuff": "golden_iot_straggler+fedbuff"}


@pytest.mark.parametrize("key", sorted(GOLDEN_KEYS))
def test_golden_integer_anchors(key):
    """The committed goldens' integer fields as fixed anchors (their
    floats no longer reproduce under the installed jax)."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[key]
    got = _run(CASES[GOLDEN_KEYS[key]], jax_side=False)["ints"]
    assert got["rounds"] == want["rounds"]
    assert got["messages"] == want["messages"]
    assert got["broadcasts"] == want["broadcasts"]
    assert got["participation"] == want["participation"]
    assert got["bytes_up"] == want["bytes_up_total"]
    assert got["staleness_hist"] == want["staleness_hist"]
    assert got["overflow_hwm"] == want["overflow_hwm"]
    assert got["far_messages"] == want["far_messages"]
    assert got["ops"] == want["ops"]


def test_fl_config_flows_through_make_simulator():
    from repro_torch.configs.base import FLConfig
    X, y = make_binary_dataset(50, 6, seed=0)
    task = LogRegTask(X, y, sample_seed=0)
    cfg = FLConfig(engine="device", cohort_block=4,
                   scenario="mobile_diurnal", aggregation="fedasync")
    sim = make_simulator(cfg, task, n_clients=4, sizes_per_client=[2],
                         round_stepsizes=[0.1], d=1, seed=0, device="cpu")
    assert sim.engine._plan.scenario.name == "mobile_diurnal"
    assert sim.engine.strategy.kind == "fedasync"
    assert sim.engine.block == 4
    assert sim.run(max_rounds=1)["final"]["round"] == 1


def test_one_tick_from_the_same_state():
    """Run the reference a few ticks, carry its state across, and advance
    both engines tick by tick from the same state (DP on, so completion
    ticks clip and noise); then the same under FedAsync with the
    overflow bucket in use, so the stratified rings ``upd_kvec`` /
    ``ovf_kvec`` and the overflow fields are compared field by field,
    and under FedBuff for ``buf_vec`` / ``buf_cnt``."""
    st = _tick_by_tick(GOLDEN_DP, 8)
    assert int(st.messages) > 0 and int(st.server_k) > 0
    st = _tick_by_tick(_with(TAIL, strategy="fedasync"), 64)
    assert int(st.far_msgs) > 0 and int(st.ovf_hwm) > 0
    assert np.asarray(st.upd_kvec).shape[1:] == (4, 13)
    assert np.abs(np.asarray(st.ovf_kvec)).sum() > 0
    st = _tick_by_tick(_with(TAIL, strategy={"kind": "fedbuff",
                                             "buffer_size": 3}), 40)
    assert int(st.messages) > 0 and np.asarray(st.buf_vec).shape == (13,)


def test_params_from_jax_carries_the_init_model():
    X, y = make_binary_dataset(50, 6, seed=0)
    jp = JaxLogRegTask(X, y).init_model()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert np.array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    assert tp["b"].shape == () and tp["b"].dtype == torch.float32
    # the port's own init draws the same normals within the normal()
    # ulp bound (test_torch_prng.py)
    own = LogRegTask(X, y).init_model()["w"].numpy()
    np.testing.assert_allclose(own, np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-9)


def test_unported_options_raise_with_their_roadmap_item():
    """The model-scale task adapter (ROADMAP Queue 1 item 11) is ported,
    so nothing the cohort engines take still raises with a ROADMAP item:
    a task without ``run_block`` that neither adapter takes raises the
    reference's ``TypeError`` from ``as_cohort_task`` and from every
    cohort engine, and a ``BatchModelTask`` adapts to
    ``CohortBatchModelTask``."""
    from repro.cohort import as_cohort_task as j_as_cohort_task
    from repro_torch import prng
    from repro_torch.cohort import CohortBatchModelTask, as_cohort_task
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    from repro_torch.models import init_params
    kw = dict(n_clients=4, sizes_per_client=[2], round_stepsizes=[0.1],
              device="cpu")
    with pytest.raises(TypeError) as jerr:
        j_as_cohort_task(object(), 4)
    msg = str(jerr.value)
    assert msg.startswith("no cohort adapter for object")
    with pytest.raises(TypeError) as err:
        as_cohort_task(object(), 4, device="cpu")
    assert str(err.value) == msg
    for engine in ("cohort", "device"):
        with pytest.raises(TypeError, match="no cohort adapter for object"):
            make_simulator(engine, object(), **kw)
    with pytest.raises(TypeError, match="no cohort adapter for object"):
        DeviceCohortSimulator(object(), **kw)
    cfg = reduced(get_config("gemma-2b"), n_layers=1, d_model=32, vocab=64)
    task = BatchModelTask(
        cfg, init_params(cfg, prng.PRNGKey(0), torch.float32, device="cpu"),
        SeedAddressedBatcher(cfg, batch_size=1, seq_len=8, device="cpu"))
    ctask = as_cohort_task(task, 4, device="cpu")
    assert isinstance(ctask, CohortBatchModelTask) and ctask.C == 4
    assert as_cohort_task(ctask, 4) is ctask
    sim = make_simulator("device", task, **kw)
    assert isinstance(sim.ctask, CohortBatchModelTask)


def test_engines_and_windows_of_items_6_and_9_build():
    """The host cohort engine and the event simulator build through
    ``make_simulator`` and run a round; the continuous-time windows of
    ``Diurnal`` and ``RenewalChurn`` build and integrate."""
    from repro_torch.cohort import CohortSimulator
    from repro_torch.core import AsyncFLSimulator
    X, y = make_binary_dataset(50, 6, seed=0)
    task = LogRegTask(X, y, sample_seed=0)
    kw = dict(n_clients=4, sizes_per_client=[2], round_stepsizes=[0.1],
              device="cpu")
    for engine, cls in (("cohort", CohortSimulator),
                        ("event", AsyncFLSimulator)):
        sim = make_simulator(engine, task, **kw)
        assert isinstance(sim, cls)
        assert sim.run(max_rounds=1)["final"]["round"] == 1
    for av in (tscn.Diurnal(), tscn.RenewalChurn()):
        win = av.windows(4, 0)
        t = win.advance(1, 0.0, 10.0)
        assert t >= 10.0
        assert abs(win.on_time(1, 0.0, t) - 10.0) < 1e-9


def test_options_of_this_slice_run():
    """FedAsync, a stochastic preset, in-kernel DP noise and sampled
    latency past the ring: each constructs and completes a round."""
    X, y = make_binary_dataset(50, 6, seed=0)
    task = LogRegTask(X, y, sample_seed=0, dp_clip=0.1, dp_sigma=1.0)
    kw = dict(n_clients=4, sizes_per_client=[2], round_stepsizes=[0.1],
              device="cpu")
    for extra in (dict(strategy="fedasync"), dict(scenario="iot_straggler"),
                  dict(dp_rng="in_kernel"),
                  dict(block=4, latency=(0.5, 9.0))):
        res = DeviceCohortSimulator(task, **kw, **extra).run(max_rounds=1)
        assert res["final"]["round"] == 1
    with pytest.raises(ValueError, match="dp_rng"):
        DeviceCohortSimulator(task, dp_rng="nope", **kw)


def test_in_kernel_noise_keeps_the_reference_integer_state():
    """dp_rng="in_kernel" on the CPU (the kernel's plain version) against
    the JAX run with operand noise: the noise never feeds the integer
    protocol, so every integer field is the reference's."""
    for cfg in (GOLDEN_DP, _with(TAIL, strategy="fedasync")):
        want = _run(cfg, jax_side=True)
        got = _run(_with(cfg, dp_rng="in_kernel"), jax_side=False)
        assert got["ints"] == want["ints"]
        assert not np.allclose(got["model"], want["model"])


def test_overflow_exhaustion_stops_on_the_tick_like_the_reference():
    """More distinct far arrival ticks in one completion tick than the
    F = 16 unroll covers: both engines latch err on that tick, stop the
    loop there and raise with the ring_cap advice, with equal state."""
    X, y = make_binary_dataset(300, 12, seed=9, noise=0.3)
    kw = dict(n_clients=64, sizes_per_client=[4], round_stepsizes=[0.1],
              d=2, seed=2, block=4)
    states = []
    for mod, sim_cls, task_cls, extra in (
            (jscn, JaxSimulator, JaxLogRegTask, {}),
            (tscn, DeviceCohortSimulator, LogRegTask, {"device": "cpu"})):
        scn = mod.Scenario("wide", mod.LatencyTable.from_uniform(
            1.0, 400.0, 64), ring_cap=2)
        sim = sim_cls(task_cls(X, y, l2=1 / 300, sample_seed=21),
                      scenario=scn, **kw, **extra)
        assert sim.engine.F == 16
        with pytest.raises(RuntimeError, match="ring_cap"):
            sim.run(max_rounds=3)
        st = sim.engine.state
        states.append({f: _np(getattr(st, f)) for f in st._fields})
    want, got = states
    assert int(got["err"]) == 1
    for f, a in want.items():
        if a.dtype == np.int32:
            assert np.array_equal(a, got[f]), f


@pytest.mark.parametrize("dp_rng", ["operand", "in_kernel"])
def test_engine_without_agg_is_bitwise_the_engine_with_it(dp_rng,
                                                          monkeypatch):
    """The engine asks the clip+noise kernels for no weighted sum: its run
    (every state field, integers and floats, losses and model) is bit
    for bit the run that has them compute and drop it."""
    from repro_torch.cohort import device as dmod
    cfg = _with(TAIL, strategy="fedasync", dp_rng=dp_rng)
    calls = []

    def run():
        n, d, seed = cfg["data"]
        X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
        sim = DeviceCohortSimulator(LogRegTask(X, y, **cfg["task"]),
                                    **_scenario(cfg["sim"], False),
                                    device="cpu")
        res = sim.run(max_rounds=cfg["rounds"], eval_every=cfg["eval_every"])
        st = sim.engine.state
        return ({f: _np(getattr(st, f)) for f in st._fields},
                [h["loss"] for h in res["history"]])

    def with_agg(fn):
        def call(*a, **k):
            calls.append(k.get("with_agg"))
            out, agg = fn(*a, **dict(k, with_agg=True))
            assert agg is not None
            return out, agg
        return call

    got = run()
    for name in ("cohort_clip_noise", "cohort_clip_noise_prng"):
        monkeypatch.setattr(dmod, name, with_agg(getattr(dmod, name)))
    want = run()
    assert calls and set(calls) == {False}
    for f, a in want[0].items():
        assert a.dtype == got[0][f].dtype
        assert np.array_equal(np.atleast_1d(a).view(np.uint8),
                              np.atleast_1d(got[0][f]).view(np.uint8)), f
    assert want[1] == got[1]
