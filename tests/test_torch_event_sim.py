"""The port's discrete-event simulator (repro_torch.core.simulator, on the
CPU) against the live reference (repro.core.simulator).

Both start from the same ``w0`` (the reference's, carried across by
``convert.event_models_from_jax``).  Integers are exact — messages,
broadcasts, the staleness histogram, participation, bytes, the server's
``processed`` audit log, the final virtual time — and the model within
rtol 1e-5 / atol 1e-7.  Cases: ``uniform``, ``mobile_diurnal`` (diurnal
windows), ``sensor_renewal`` (renewal windows), FedAsync and FedBuff, DP
on, both sampling modes (``sample_seed`` and split + ``randint``),
``record_invariant=True``; the three-way parity at ``d = 1``
(tests/test_cohort_parity.py); ``run_sync_baseline``; the windows and the
latency-seconds draws themselves.
"""
import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscn
from repro.core import AsyncFLSimulator as JaxEvent
from repro.core import LogRegTask as JaxLogRegTask
from repro.core import run_sync_baseline as jax_sync_baseline
from repro_torch import (AsyncFLSimulator, CohortSimulator,
                         DeviceCohortSimulator, LogRegTask, make_simulator,
                         run_sync_baseline)
from repro_torch import scenarios as tscn
from repro_torch.convert import event_models_from_jax
from repro_torch.data import make_binary_dataset

RTOL, ATOL = 1e-5, 1e-7
CPU = "cpu"

BASE = dict(data=(300, 12, 9), task=dict(l2=1.0 / 300, sample_seed=21),
            sim=dict(n_clients=6, sizes_per_client=[4, 6, 8],
                     round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2),
            rounds=3)


def _with(cfg, task=None, **sim):
    return dict(cfg, task=dict(cfg["task"], **(task or {})),
                sim=dict(cfg["sim"], **sim))


_NO_SEED = dict(l2=1.0 / 300)
CASES = {
    "uniform": _with(BASE, scenario="uniform"),
    "mobile_diurnal": _with(BASE, scenario="mobile_diurnal"),
    "sensor_renewal": _with(BASE, scenario="sensor_renewal"),
    "fedasync_dp_diurnal": _with(BASE, task=dict(dp_clip=0.1, dp_sigma=2.0),
                                 scenario="mobile_diurnal",
                                 strategy="fedasync"),
    "fedbuff_renewal": _with(BASE, scenario="sensor_renewal",
                             strategy={"kind": "fedbuff",
                                       "buffer_size": 3}),
    "fedasync_hinge": _with(BASE, strategy={"kind": "fedasync",
                                            "decay": "hinge",
                                            "hinge_b": 0}),
    "randint_sampling": dict(_with(BASE, scenario="uniform"),
                             task=_NO_SEED),
    "randint_sampling_dp_legacy": dict(
        BASE, task=dict(_NO_SEED, dp_clip=0.1, dp_sigma=2.0)),
    "record_invariant": _with(BASE, record_invariant=True,
                              global_sizes=[24, 36, 48]),
}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _summary(sim, res):
    tel = res["telemetry"]
    m = res["model"]
    return {
        "ints": {
            "round": int(res["final"]["round"]),
            "messages": int(tel.messages),
            "broadcasts": int(tel.broadcasts),
            "staleness_hist": [int(x) for x in tel.staleness_hist],
            "participation": [int(x) for x in tel.participation],
            "bytes_up": [int(x) for x in tel.bytes_up],
            "processed": list(sim.server.processed),
            "client_rounds": [(c.i, c.h, c.k) for c in sim.clients],
            "delay_trace": [list(c.delay_trace) for c in sim.clients],
        },
        "time": float(res["final"]["time"]),
        "model": np.concatenate([_np(m["w"]).ravel(),
                                 _np(m["b"]).reshape(1)]),
        "losses": [float(h["loss"]) for h in res["history"]]
        + [float(res["final"]["loss"])],
        "dp": tel.dp,
    }


def _pair(cfg, device=CPU):
    n, d, seed = cfg["data"]
    X, y = make_binary_dataset(n, d, seed=seed, noise=0.3)
    jsim = JaxEvent(JaxLogRegTask(X, y, **cfg["task"]), **cfg["sim"])
    tsim = AsyncFLSimulator(LogRegTask(X, y, **cfg["task"]), **cfg["sim"],
                            device=device)
    as_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    event_models_from_jax(tsim, as_np(jsim.server.v),
                          [as_np(c.w) for c in jsim.clients])
    return jsim, tsim


def _run_pair(cfg):
    jsim, tsim = _pair(cfg)
    want = _summary(jsim, jsim.run(max_rounds=cfg["rounds"]))
    got = _summary(tsim, tsim.run(max_rounds=cfg["rounds"]))
    return want, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_event_sim_matches_reference(case):
    want, got = _run_pair(CASES[case])
    assert got["ints"] == want["ints"]
    assert got["time"] == want["time"]
    np.testing.assert_allclose(got["model"], want["model"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL,
                               atol=ATOL)
    assert got["dp"] == want["dp"]
    if case == "record_invariant":
        assert any(got["ints"]["delay_trace"])


def test_epoch_hash_churn_is_rejected_like_the_reference():
    X, y = make_binary_dataset(50, 4, seed=0)
    for name in ("iot_straggler", "geo_regional"):
        with pytest.raises(ValueError, match="continuous-time"):
            AsyncFLSimulator(LogRegTask(X, y), n_clients=3,
                             sizes_per_client=[2], round_stepsizes=[0.1],
                             scenario=name, device=CPU)


def test_three_way_parity_d1():
    """tests/test_cohort_parity.py's case: same sample-seeded task, d = 1.
    The port's two cohort engines are bit for bit equal; the event
    simulator matches them within atol 1e-4 (bucketed vs per-message
    server adds reorder float sums), with equal integers; and each port
    engine against its reference."""
    X, y = make_binary_dataset(500, 16, seed=7, noise=0.3)
    kw = dict(n_clients=4, sizes_per_client=[[10, 20, 30, 40]] * 4,
              round_stepsizes=[0.1, 0.08, 0.06, 0.05], d=1, seed=0,
              speeds=[1.0, 0.8, 1.2, 0.9])
    task = LogRegTask(X, y, l2=1.0 / len(X), sample_seed=13)
    ev = AsyncFLSimulator(task, **kw, device=CPU).run(max_rounds=4)
    co = CohortSimulator(task, **kw, device=CPU).run(max_rounds=4)
    dv = DeviceCohortSimulator(task, **kw, device=CPU).run(max_rounds=4)
    assert (ev["final"]["round"] == co["final"]["round"]
            == dv["final"]["round"] == 4)
    assert (ev["final"]["messages"] == co["final"]["messages"]
            == dv["final"]["messages"])
    assert (list(ev["telemetry"].participation)
            == list(co["telemetry"].participation)
            == list(dv["telemetry"].participation))
    assert (list(ev["telemetry"].staleness_hist)
            == list(co["telemetry"].staleness_hist)
            == list(dv["telemetry"].staleness_hist))
    for f in ("w", "b"):
        assert torch.equal(co["model"][f].view(torch.int32),
                           dv["model"][f].view(torch.int32))
    np.testing.assert_allclose(ev["model"]["w"].numpy(),
                               dv["model"]["w"].numpy(), atol=1e-4)
    np.testing.assert_allclose(float(ev["model"]["b"]),
                               float(dv["model"]["b"]), atol=1e-4)
    jtask = JaxLogRegTask(X, y, l2=1.0 / len(X), sample_seed=13)
    jev = JaxEvent(jtask, **kw).run(max_rounds=4)
    assert ev["final"]["messages"] == jev["final"]["messages"]
    np.testing.assert_allclose(ev["model"]["w"].numpy(),
                               np.asarray(jev["model"]["w"]), atol=1e-6)


@pytest.mark.parametrize("sample_seed", [None, 4])
def test_sync_baseline_matches_reference(sample_seed):
    X, y = make_binary_dataset(200, 10, seed=3, noise=0.3)
    kw = dict(n_clients=3, n_rounds=3, sample_size=5, eta=0.05, seed=1)
    want = jax_sync_baseline(JaxLogRegTask(X, y, l2=0.005,
                                           sample_seed=sample_seed), **kw)
    got = run_sync_baseline(LogRegTask(X, y, l2=0.005,
                                       sample_seed=sample_seed), **kw,
                            device=CPU)
    for f in ("w", "b"):
        np.testing.assert_allclose(_np(got["model"][f]),
                                   np.asarray(want["model"][f]), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["uniform", "mobile_diurnal",
                                  "iot_straggler", "geo_regional"])
def test_latency_seconds_bitwise(name):
    """The event simulator's latency draws: the reference's bins and
    f32-rounded seconds, bit for bit, for updates and broadcasts."""
    C, seed = 9, 5
    jp = jscn.scenario_plan(jscn.get_scenario(name), C=C, seed=seed)
    tp = tscn.ScenarioPlan(tscn.get_scenario(name), C=C, seed=seed)
    for r in (0, 1, 7, 300):
        assert np.array_equal(jp.update_latencies_s(r),
                              tp.update_latencies_s(r))
        assert np.array_equal(jp.broadcast_latencies_s(r + 1),
                              tp.broadcast_latencies_s(r + 1))
        assert jp.update_latency_s(3, r) == tp.update_latency_s(3, r)


def test_diurnal_windows_bitwise():
    jw = jscn.Diurnal(period_s=100.0, on_frac=0.6).windows(5, 3)
    tw = tscn.Diurnal(period_s=100.0, on_frac=0.6).windows(5, 3)
    for c in range(5):
        for t0 in (0.0, 13.7, 250.25):
            for w in (0.0, 5.5, 60.0, 333.3):
                assert tw.advance(c, t0, w) == jw.advance(c, t0, w)
                assert tw.on_time(c, t0, t0 + w) == jw.on_time(c, t0, t0 + w)
    assert tscn.Diurnal(on_frac=1.0).windows(5, 3) is None
    assert tscn.AlwaysOn().windows(5, 3) is None


def test_renewal_windows_match_reference():
    """Renewal windows read switch times that go through torch's
    ``log1p`` (an ulp off XLA's on a few percent of inputs): states at
    sampled times are equal, integrated on-time within 1e-4 s."""
    av = dict(on_rate=1.0 / 16.0, off_rate=1.0 / 48.0)
    jw = jscn.RenewalChurn(**av).windows(6, 11)
    tw = tscn.RenewalChurn(**av).windows(6, 11)
    for c in range(6):
        for t in np.linspace(0.0, 700.0, 57):
            assert tw.on_at(c, float(t)) == jw.on_at(c, float(t))
        for t0, w in ((0.0, 10.0), (30.0, 100.0), (100.0, 400.0)):
            np.testing.assert_allclose(tw.advance(c, t0, w),
                                       jw.advance(c, t0, w), atol=1e-4)
            np.testing.assert_allclose(tw.on_time(c, t0, t0 + w),
                                       jw.on_time(c, t0, t0 + w), atol=1e-4)


def test_make_simulator_builds_the_event_engine():
    from repro_torch.configs.base import FLConfig
    X, y = make_binary_dataset(100, 8, seed=0, noise=0.3)
    task = LogRegTask(X, y, sample_seed=0)
    sim = make_simulator(FLConfig(engine="event", cohort_block=7,
                                  aggregation="fedbuff"), task, n_clients=2,
                         sizes_per_client=[2], round_stepsizes=[0.1], d=1,
                         seed=0, device=CPU)
    assert isinstance(sim, AsyncFLSimulator)
    assert sim.server.strategy.kind == "fedbuff"
    assert sim.run(max_rounds=2)["final"]["round"] == 2


def test_aggregator_tree_matches_reference():
    """The aggregator tree over the port's protocol messages: the same
    forwarded rounds, min ``k_send`` and sums as the reference's, and a
    server fed through it lands where the flat server does."""
    from repro.core import aggregators as JAgg
    from repro.core.protocol import UpdateMsg as JMsg
    from repro_torch.core import aggregators as TAgg
    from repro_torch.core.protocol import Server, UpdateMsg
    rng = np.random.default_rng(0)
    n, fan_in = 5, 2
    Us = [{"w": rng.normal(size=3).astype(np.float32)} for _ in range(n)]
    jt, tt = JAgg.build_tree(n, fan_in), TAgg.build_tree(n, fan_in)
    tree_srv = Server({"w": torch.zeros(3)}, n_clients=len(tt),
                      round_stepsizes=[0.1])
    flat = Server({"w": torch.zeros(3)}, n_clients=n, round_stepsizes=[0.1])
    for c in (3, 0, 4, 1, 2):
        a = jt[c // fan_in].receive(JMsg(0, c, Us[c], k_send=c % 3))
        tu = {"w": torch.as_tensor(Us[c]["w"])}
        b = tt[c // fan_in].receive(UpdateMsg(0, c, tu, k_send=c % 3))
        flat.receive(UpdateMsg(0, c, tu))
        assert (a is None) == (b is None)
        if b is not None:
            assert (b.round_idx, b.client_id, b.k_send) == (
                a.round_idx, a.client_id, a.k_send)
            assert np.array_equal(b.U["w"].numpy(), np.asarray(a.U["w"]))
            tree_srv.receive(b)
    assert flat.k == tree_srv.k == 1
    np.testing.assert_allclose(flat.v["w"].numpy(), tree_srv.v["w"].numpy(),
                               rtol=1e-6)
    assert (TAgg.tree_message_counts(100, 10, 195)
            == JAgg.tree_message_counts(100, 10, 195))


def test_ordering_splits_and_helpers_match_reference():
    """The iteration-ordering map rho, the federated splits and the small
    helpers the event engine's pieces use, against the reference."""
    from repro.core import ordering as JO
    from repro.core.tasks import global_norm as j_global_norm
    from repro.data import biased_split as j_biased
    from repro.data import unbiased_split as j_unbiased
    from repro.telemetry.report import model_flat_dim as j_flat_dim
    from repro_torch.core import ordering as TO
    from repro_torch.core.tasks import global_norm
    from repro_torch.data import biased_split, unbiased_split
    from repro_torch.telemetry import model_flat_dim
    a_j = JO.make_assignment([5, 9, 14], [0.2, 0.5, 0.3], seed=4)
    a_t = TO.make_assignment([5, 9, 14], [0.2, 0.5, 0.3], seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(a_j, a_t))
    assert TO.client_sizes(a_t, 3) == JO.client_sizes(a_j, 3)
    assert TO.is_bijection(a_t, 3)
    for t in range(28):
        assert TO.rho_inverse(a_t, t) == JO.rho_inverse(a_j, t)
    X, y = make_binary_dataset(120, 4, seed=1, noise=0.3)
    for bias in (0.0, 0.7, 1.0):
        for (xa, ya), (xb, yb) in zip(j_biased(X, y, 4, bias=bias, seed=2),
                                      biased_split(X, y, 4, bias=bias,
                                                   seed=2)):
            assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    for (xa, _), (xb, _) in zip(j_unbiased(X, y, 3, seed=5),
                                unbiased_split(X, y, 3, seed=5)):
        assert np.array_equal(xa, xb)
    p = {"w": np.arange(6, dtype=np.float32) / 7, "b": np.float32(-0.3)}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    np.testing.assert_allclose(float(global_norm(tp)),
                               float(j_global_norm(p)), rtol=1e-7)
    assert model_flat_dim(tp) == j_flat_dim(p) == 7
