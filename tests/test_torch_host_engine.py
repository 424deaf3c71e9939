"""The port's host-loop cohort engine (repro_torch.cohort.engine, on the
CPU, i.e. over the plain kernel versions) against the live reference's
host engine and against the port's own device engine.

For every case of test_torch_device_engine.py (the golden ``uniform``
case and its DP variant, ``fedsgd_r8_s1``, the four other golden
pairings, ``geo_regional``, ``sensor_renewal`` and the overflow "tail"
scenario under each strategy with DP on):

* port host vs reference host: integers exact (rounds, messages,
  broadcasts, participation, bytes, staleness histogram, overflow
  high-water mark, far messages, op census, ticks); losses and the model
  within the goldens' rtol 1e-5 / atol 1e-7;
* port host vs port device (operand noise): every field bit for bit —
  the integers, the losses, the model and the final ``w``/``U``/``v``.

Also the reference's own host-vs-device cases
(tests/test_cohort_parity.py), the legacy ``latency_fn`` path among
them, and the two host engines stepped tick by tick from the same
converted state.
"""
import types

import numpy as np
import pytest
import torch

from repro.cohort import CohortSimulator as JaxHost
from repro.core import LogRegTask as JaxLogRegTask
from repro_torch import (CohortSimulator, DeviceCohortSimulator, LogRegTask,
                         make_simulator)
from repro_torch.convert import host_state_from_jax
from repro_torch.data import make_binary_dataset
from repro_torch.telemetry.costs import OP_FAR_GROUPS
from test_torch_device_engine import (ATOL, CASES, GOLDEN_DP, RTOL, TAIL,
                                      _np, _scenario, _with)

CPU = "cpu"


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(_np(x)).reshape(-1).view(np.uint8)


def _sim(cfg, which, **extra):
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    kw = dict(_scenario(cfg["sim"], which == "jax"), **extra)
    if which == "jax":
        return JaxHost(JaxLogRegTask(X, y, **cfg["task"]), **kw)
    cls = CohortSimulator if which == "host" else DeviceCohortSimulator
    return cls(LogRegTask(X, y, **cfg["task"]), **kw, device=CPU)


def _run(cfg, which, **extra):
    sim = _sim(cfg, which, **extra)
    res = sim.run(max_rounds=cfg["rounds"], eval_every=cfg["eval_every"])
    fin, tel = res["final"], res["telemetry"]
    st = sim.engine.state
    return {
        "ints": {
            "rounds": int(fin["round"]), "messages": int(fin["messages"]),
            "broadcasts": int(fin["broadcasts"]),
            "overflow_hwm": int(fin["overflow_hwm"]),
            "far_messages": int(fin["far_messages"]),
            "participation": [int(x) for x in tel.participation],
            "bytes_up": int(tel.bytes_up.sum()),
            "staleness_hist": [int(x) for x in tel.staleness_hist],
            "ops": dict(tel.ops), "ticks": int(tel.ticks),
            **{f"client_{f}": [int(x) for x in _np(getattr(st, f))]
               for f in ("i", "h", "k", "credit")},
        },
        "losses": [float(h["loss"]) for h in res["history"]]
        + [float(fin["loss"])],
        "model": np.concatenate([_np(res["model"]["w"]).ravel(),
                                 _np(res["model"]["b"]).reshape(1)]),
        "blocks": {f: _np(getattr(st, f)) for f in ("w", "U", "v")},
        "dp": tel.dp,
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_engine_matches_reference_and_device_engine(case):
    cfg = CASES[case]
    got = _run(cfg, "host")
    want = _run(cfg, "jax")
    assert got["ints"] == want["ints"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                               atol=ATOL)
    assert got["dp"] == want["dp"]
    dev = _run(cfg, "device")
    assert got["ints"] == dev["ints"]
    assert got["losses"] == dev["losses"]
    assert np.array_equal(_bits(got["model"]), _bits(dev["model"]))
    for f in ("w", "U", "v"):
        assert np.array_equal(_bits(got["blocks"][f]),
                              _bits(dev["blocks"][f])), f


def test_tail_cases_use_the_far_tier():
    """The tail cases route updates past the ring: the far tier's one
    ``[V, C]`` product per completion tick is on the tested path."""
    for strat in (None, "fedasync"):
        sim = _sim(_with(TAIL, strategy=strat), "host")
        res = sim.run(max_rounds=TAIL["rounds"])
        assert res["final"]["far_messages"] > 0
        assert res["telemetry"].ops["far_groups"] > 0
        assert res["final"]["overflow_hwm"] > 0


# -- the reference's host-vs-device cases (tests/test_cohort_parity.py) --

def _parity_kw():
    X, y = make_binary_dataset(300, 12, seed=9, noise=0.3)
    task = dict(l2=1.0 / 300, dp_clip=0.1, dp_sigma=2.0, sample_seed=21)
    kw = dict(n_clients=5, sizes_per_client=[4, 6, 8],
              round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=3,
              speeds=[1.0, 0.6, 1.4, 0.8, 1.1], block=4,
              dp_round_clip=0.5)
    return X, y, task, kw


def test_legacy_latency_fn_matches_device_and_reference():
    """DP noise, round clip, d = 2 mid-round ISRRECEIVE and a 2-tick
    constant latency: the host engine's legacy ``latency_fn`` path is bit
    for bit the device engine's ``latency=5.0``, and the reference host
    engine's integers."""
    X, y, task, kw = _parity_kw()
    host = CohortSimulator(LogRegTask(X, y, **task), latency_fn=lambda r: 5.0,
                           **kw, device=CPU).run(max_rounds=3)
    dev = DeviceCohortSimulator(LogRegTask(X, y, **task), latency=5.0, **kw,
                                device=CPU).run(max_rounds=3)
    ref = JaxHost(JaxLogRegTask(X, y, **task), latency_fn=lambda r: 5.0,
                  **kw).run(max_rounds=3)
    for f in ("w", "b"):
        assert np.array_equal(_bits(host["model"][f]), _bits(dev["model"][f]))
        np.testing.assert_allclose(_np(host["model"][f]),
                                   np.asarray(ref["model"][f]), rtol=RTOL,
                                   atol=ATOL)
    for k in ("messages", "broadcasts", "round"):
        assert host["final"][k] == dev["final"][k] == ref["final"][k]
    assert host["telemetry"].ops == dev["telemetry"].ops \
        == ref["telemetry"].ops


def test_legacy_latency_fn_draws_the_reference_numpy_stream():
    """A stochastic host ``latency_fn`` draws from the engine's numpy
    generator in the reference's order: the same tick schedule."""
    X, y, task, kw = _parity_kw()
    lat = lambda r: 2.0 + 9.0 * r.random()  # noqa: E731
    host = CohortSimulator(LogRegTask(X, y, **task), latency_fn=lat, **kw,
                           device=CPU).run(max_rounds=3)
    ref = JaxHost(JaxLogRegTask(X, y, **task), latency_fn=lat, **kw).run(
        max_rounds=3)
    assert host["telemetry"].ops == ref["telemetry"].ops
    assert (list(host["telemetry"].staleness_hist)
            == list(ref["telemetry"].staleness_hist))
    np.testing.assert_allclose(_np(host["model"]["w"]),
                               np.asarray(ref["model"]["w"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(sizes_per_client=[8] * 3, round_stepsizes=[0.1, 0.08, 0.06],
         speeds=[1.0, 1.0 / 512.0], block=8, rounds=3),
    dict(sizes_per_client=[1, 5000], round_stepsizes=[0.1, 0.05], block=4,
         rounds=2)], ids=["speed_ratio_512", "increasing_sizes"])
def test_no_spurious_stall(kw):
    """The stall budget covers a 512x speed ratio and an increasing
    schedule (the reference's regressions); at the speed ratio host and
    device also agree bit for bit."""
    X, y = make_binary_dataset(200, 8, seed=5, noise=0.3)
    kw = dict(kw)
    rounds = kw.pop("rounds")
    classes = ((CohortSimulator, DeviceCohortSimulator) if "speeds" in kw
               else (CohortSimulator,))
    out = []
    for cls in classes:
        res = cls(LogRegTask(X, y, l2=1.0 / 200, sample_seed=2), n_clients=2,
                  d=1, seed=0, device=CPU, **kw).run(max_rounds=rounds)
        assert res["final"]["round"] == rounds
        out.append(res)
    for res in out[1:]:
        assert np.array_equal(_bits(out[0]["model"]["w"]),
                              _bits(res["model"]["w"]))
        assert out[0]["telemetry"].ops == res["telemetry"].ops


def test_gate_d2_converges_like_the_reference():
    X, y = make_binary_dataset(600, 16, seed=2, noise=0.3)
    kw = dict(n_clients=6, sizes_per_client=[4, 5, 6, 7, 8],
              round_stepsizes=[0.1, 0.08, 0.06, 0.05, 0.04], d=2, seed=1,
              speeds=[1.0, 0.5, 1.5, 0.7, 1.2, 0.9], block=4)
    task = LogRegTask(X, y, l2=1.0 / len(X), sample_seed=3)
    loss0 = task.metrics(task.init_model(device=CPU))["loss"]
    res = CohortSimulator(task, **kw, device=CPU).run(max_rounds=5)
    ref = JaxHost(JaxLogRegTask(X, y, l2=1.0 / len(X), sample_seed=3),
                  **kw).run(max_rounds=5)
    assert res["final"]["round"] == 5 and res["final"]["loss"] < loss0
    assert res["final"]["messages"] == ref["final"]["messages"] >= 30
    assert res["telemetry"].ops == ref["telemetry"].ops


def test_dp_noise_perturbs_the_model():
    X, y = make_binary_dataset(400, 16, seed=4, noise=0.3)
    kw = dict(n_clients=4, sizes_per_client=[6, 8],
              round_stepsizes=[0.1, 0.08], d=1, seed=0, device=CPU)
    clean = CohortSimulator(LogRegTask(X, y, l2=1.0 / 400, sample_seed=5),
                            **kw).run(max_rounds=2)["model"]["w"]
    noisy = CohortSimulator(
        LogRegTask(X, y, l2=1.0 / 400, dp_clip=0.1, dp_sigma=4.0,
                   sample_seed=5), **kw).run(max_rounds=2)["model"]["w"]
    assert float((clean - noisy).abs().max()) > 1e-5


# -- one tick from the same state ---------------------------------------

_COUNTERS = ("total_messages", "total_broadcasts", "ovf_hwm",
             "far_messages")
_ARRAYS = ("part", "bytes_up", "stale_hist", "ops")


def _carry(je, te):
    """Install the reference host engine's state and counters, as numpy
    copies, into the port's host engine."""
    js = je.state
    np_state = types.SimpleNamespace(
        **{f: np.asarray(getattr(js, f)) for f in
           ("w", "U", "v", "i", "h", "k", "credit")},
        server_k=js.server_k, tick=js.tick)
    np_upd = types.SimpleNamespace(
        contrib={t: np.asarray(v) for t, v in je.updates.contrib.items()},
        far_contrib={t: np.asarray(v)
                     for t, v in je.updates.far_contrib.items()},
        meta={t: list(p) for t, p in je.updates.meta.items()})
    np_bc = types.SimpleNamespace(pending=[
        {"k": b["k"], "v": np.asarray(b["v"]), "at": np.asarray(b["at"])}
        for b in je.bcasts.pending])
    te.state, te.updates, te.bcasts = host_state_from_jax(np_state, np_upd,
                                                          np_bc)
    te._h_counts = dict(je._h_counts)
    for f in _COUNTERS:
        setattr(te, f, int(getattr(je, f)))
    for f in _ARRAYS:
        setattr(te, f, np.array(getattr(je, f), dtype=np.int64))
    if je.strategy.buffered:
        te._buf_vec = torch.tensor(np.asarray(je._buf_vec))
        te._buf_cnt = int(je._buf_cnt)


def _close(a, b, what):
    a, b = _np(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what)


def _compare(je, te, t):
    js, ts = je.state, te.state
    for f in ("i", "h", "k", "credit"):
        assert np.array_equal(getattr(ts, f), np.asarray(getattr(js, f))), \
            (t, f)
    assert (ts.server_k, ts.tick) == (js.server_k, js.tick)
    for f in ("w", "U", "v"):
        _close(getattr(ts, f), getattr(js, f), f"tick {t} {f}")
    for name in ("contrib", "far_contrib"):
        a, b = getattr(te.updates, name), getattr(je.updates, name)
        assert sorted(a) == sorted(b), (t, name)
        for tick in a:
            _close(a[tick], b[tick], f"tick {t} {name}[{tick}]")
    assert te.updates.meta == {k: list(v) for k, v in je.updates.meta.items()}
    assert [(b["k"], b["at"].tolist()) for b in te.bcasts.pending] \
        == [(b["k"], np.asarray(b["at"]).tolist()) for b in je.bcasts.pending]
    assert te._h_counts == je._h_counts
    for f in _COUNTERS:
        assert getattr(te, f) == getattr(je, f), (t, f)
    for f in _ARRAYS:
        assert np.array_equal(getattr(te, f), getattr(je, f)), (t, f)
    if je.strategy.buffered:
        _close(te._buf_vec, je._buf_vec, f"tick {t} buf_vec")
        assert te._buf_cnt == je._buf_cnt


def _tick_by_tick(cfg, ticks):
    je = _sim(cfg, "jax").engine
    te = _sim(cfg, "host").engine
    for t in range(1, ticks + 1):
        _carry(je, te)
        je.step()
        te.step()
        _compare(je, te, t)
    return je


def test_one_tick_from_the_same_state():
    """Carry the reference host engine's state across each tick and step
    both engines from it: DP on (completion ticks clip and noise); then
    FedAsync with the overflow bucket in use (stratified near and far
    buckets); then FedBuff (its buffer)."""
    je = _tick_by_tick(GOLDEN_DP, 10)
    assert je.total_messages > 0 and je.state.server_k > 0
    je = _tick_by_tick(_with(TAIL, strategy="fedasync"), 64)
    assert je.far_messages > 0 and je.ovf_hwm > 0
    assert je.ops[OP_FAR_GROUPS] > 0
    je = _tick_by_tick(_with(TAIL, strategy={"kind": "fedbuff",
                                             "buffer_size": 3}), 40)
    assert je.total_messages > 0


def test_make_simulator_builds_the_cohort_engine():
    from repro_torch.cohort.engine import CohortEngine
    from repro_torch.configs.base import FLConfig
    X, y = make_binary_dataset(200, 16, seed=0, noise=0.3)
    task = LogRegTask(X, y, sample_seed=0)
    kw = dict(n_clients=2, sizes_per_client=[2], round_stepsizes=[0.1], d=1,
              seed=0, device=CPU)
    sim = make_simulator(FLConfig(engine="cohort", cohort_block=7,
                                  scenario="mobile_diurnal",
                                  aggregation="fedasync"), task, **kw)
    assert isinstance(sim, CohortSimulator)
    assert isinstance(sim.engine, CohortEngine)
    assert sim.engine.block == 7 and sim.engine.strategy.kind == "fedasync"
    assert sim.engine._plan.scenario.name == "mobile_diurnal"
    assert sim.run(max_rounds=1)["final"]["round"] == 1
    with pytest.raises(ValueError, match="latency"):
        make_simulator("device", task, latency_fn=lambda r: 0.1, **kw)
    with pytest.raises(ValueError):
        make_simulator("vmap", task, **kw)
