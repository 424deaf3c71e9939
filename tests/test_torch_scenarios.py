"""The port's scenario subsystem (repro_torch.scenarios) against the live
JAX reference (repro.scenarios), on the same seeds.

Every draw is bitwise: latency tables and their alias arrays, the
message-addressed update and broadcast tick draws of ``ScenarioPlan``,
the availability masks, the drawn table ids and the speed draws — for
every preset at C = 64, over rounds, broadcast counters and ticks that
cross availability epochs, at tick lengths where the latency tables
quantize to several tick counts.
"""
import json

import numpy as np
import pytest
import torch

from repro import scenarios as J
from repro.scenarios import registry as jreg
from repro_torch import scenarios as T

PRESETS = ["uniform", "mobile_diurnal", "iot_straggler", "geo_regional",
           "sensor_renewal"]
C = 64
DTS = [0.05, 0.7, 4.0]


def _plans(name, dt, seed=3):
    jp = jreg.ScenarioPlan(J.get_scenario(name), C=C, seed=seed, dt=dt)
    tp = T.ScenarioPlan(T.get_scenario(name), C=C, seed=seed, dt=dt,
                        device="cpu")
    return jp, tp


@pytest.mark.parametrize("name", PRESETS)
def test_preset_tables_and_plan_geometry_match(name):
    js, ts = J.get_scenario(name), T.get_scenario(name)
    assert len(js.tables) == len(ts.tables)
    for a, b in zip(js.tables, ts.tables):
        assert a.values == b.values and a.probs == b.probs
        pa, aa = J.vose_alias(a.probs)
        pb, ab = T.vose_alias(b.probs)
        assert np.array_equal(pa, pb) and np.array_equal(aa, ab)
        for dt in DTS:
            assert np.array_equal(a.tick_values(dt), b.tick_values(dt))
    assert js.ring_cap == ts.ring_cap
    for dt in DTS:
        jp, tp = _plans(name, dt)
        assert np.array_equal(jp.table_id, tp.table_id)
        assert jp.max_lat_ticks == tp.max_lat_ticks
        assert jp.ring_ticks == tp.ring_ticks
        assert jp.far_tick_values == tp.far_tick_values
        assert jp._ticks_const == tp._ticks_const
        assert jp.duty == tp.duty


@pytest.mark.parametrize("dt", DTS)
@pytest.mark.parametrize("name", PRESETS)
def test_update_and_broadcast_draws_bitwise(name, dt):
    jp, tp = _plans(name, dt)
    rng = np.random.default_rng(0)
    rounds = [np.full(C, r, np.int32) for r in range(6)]
    rounds += [rng.integers(0, 40, C).astype(np.int32) for _ in range(4)]
    for i in rounds:
        want = jp.host_update_ticks(i)
        got = tp.update_ticks(torch.as_tensor(i))
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy()), i
    for k in list(range(0, 24)) + [1000, 65537]:
        want = jp.host_broadcast_ticks(k)
        assert np.array_equal(want, tp.broadcast_ticks(k).numpy()), k
        # the cache hands back the same draw
        assert np.array_equal(want, tp.broadcast_ticks(k).numpy()), k


@pytest.mark.parametrize("dt", [0.7, 4.0])
@pytest.mark.parametrize("name", PRESETS)
def test_avail_mask_bitwise_across_epochs(name, dt):
    jp, tp = _plans(name, dt)
    assert (jp.avail_mask is None) == (tp.avail_mask is None)
    if jp.avail_mask is None:
        return
    ticks = sorted(set(range(0, 1400, 13)) | set(range(60, 70))
                   | set(range(360, 372)) | set(range(2040, 2060)))
    for t in ticks:
        want = jp.host_avail(t)
        got = tp.avail_mask(t)
        assert got.dtype == torch.bool
        assert np.array_equal(want, got.numpy()), t


@pytest.mark.parametrize("T_n,weights", [(2, (0.6, 0.4)), (3, None),
                                         (5, (1.0, 0.0, 2.0, 0.5, 3.0)),
                                         (17, None)])
def test_draw_table_ids_bitwise(T_n, weights):
    for seed in (0, 2, 11):
        want = np.asarray(jreg.draw_table_ids(C, T_n, weights, seed))
        got = T.draw_table_ids(C, T_n, weights, seed)
        assert got.dtype == np.int32 and np.array_equal(want, got)


@pytest.mark.parametrize("kind", ["uniform", "bimodal", "zipf",
                                  "lognormal"])
def test_speed_model_draw_bitwise(kind):
    for seed in (0, 5):
        want = J.SpeedModel(kind=kind).draw(C, seed)
        got = T.SpeedModel(kind=kind).draw(C, seed)
        assert np.array_equal(want, got)


def test_alias_sampling_bitwise():
    rng = np.random.default_rng(1)
    tab = J.LatencyTable.from_lognormal(0.3, 0.8, n_bins=12)
    prob, alias = J.vose_alias(tab.probs)
    u = rng.random((500, 2), dtype=np.float32)
    want = np.asarray(J.alias_sample(u, prob, alias))
    got = T.alias_sample(torch.as_tensor(u), torch.as_tensor(prob),
                         torch.as_tensor(alias))
    assert np.array_equal(want, got.numpy())
    rows_p = np.stack([prob] * 500)
    rows_a = np.stack([alias] * 500)
    want = np.asarray(J.alias_sample_rows(u, rows_p, rows_a))
    got = T.alias_sample_rows(torch.as_tensor(u), torch.as_tensor(rows_p),
                              torch.as_tensor(rows_a))
    assert np.array_equal(want, got.numpy())


def test_table_constructors_and_traces_match(tmp_path):
    samples = [0.1, 0.4, 0.4, 1.3, 2.2, 0.05, 0.9]
    pairs = [
        (J.LatencyTable.from_samples(samples, 4),
         T.LatencyTable.from_samples(samples, 4)),
        (J.LatencyTable.from_pareto(0.1, 1.2, 12),
         T.LatencyTable.from_pareto(0.1, 1.2, 12)),
        (J.LatencyTable.mix([J.LatencyTable.constant(0.2),
                             J.LatencyTable.from_uniform(0.1, 0.5, 4)],
                            [0.3, 0.7]),
         T.LatencyTable.mix([T.LatencyTable.constant(0.2),
                             T.LatencyTable.from_uniform(0.1, 0.5, 4)],
                            [0.3, 0.7])),
    ]
    js = tmp_path / "trace.json"
    js.write_text(json.dumps({"latency_s": samples}))
    cs = tmp_path / "trace.csv"
    cs.write_text("client,latency_s\n" + "\n".join(
        f"{i % 3},{s}" for i, s in enumerate(samples)))
    pairs.append((J.LatencyTable.from_trace(str(js), 4),
                  T.LatencyTable.from_trace(str(js), 4)))
    pairs.append((J.LatencyTable.from_trace(str(cs), 4),
                  T.LatencyTable.from_trace(str(cs), 4)))
    for a, b in pairs:
        assert a.values == b.values and a.probs == b.probs
        assert np.array_equal(a.padded(20)[0], b.padded(20)[0])
        assert T.LatencyTable.from_json(b.to_json()) == b
    jt = J.LatencyTable.per_client_from_trace(str(cs), 4)
    tt = T.LatencyTable.per_client_from_trace(str(cs), 4)
    assert [(a.values, a.probs) for a in jt] == [(b.values, b.probs)
                                                 for b in tt]
    jsc = J.scenario_from_trace(str(cs), per_client=True, n_bins=4)
    tsc = T.scenario_from_trace(str(cs), per_client=True, n_bins=4)
    jp = jreg.ScenarioPlan(jsc, C=C, seed=1, dt=0.05)
    tp = T.ScenarioPlan(tsc, C=C, seed=1, dt=0.05, device="cpu")
    i = np.arange(C, dtype=np.int32) % 5
    assert np.array_equal(jp.host_update_ticks(i),
                          tp.update_ticks(torch.as_tensor(i)).numpy())
    for spec in (None, 0.3, (0.05, 0.2), (0.4, 0.4)):
        a = J.legacy_latency_scenario(spec)
        b = T.legacy_latency_scenario(spec)
        assert a.name == b.name
        assert (a.latency.values, a.latency.probs) == (b.latency.values,
                                                       b.latency.probs)


def test_event_simulator_windows_are_not_ported():
    """The name predates the port of the event simulator, which brought
    the windows: ``Diurnal`` and ``RenewalChurn`` now give the reference's
    continuous-time windows (the same on/off state at sampled times), and
    the epoch-hash churn models raise as the reference's do."""
    for jav, tav in ((J.Diurnal(), T.Diurnal()),
                     (J.RenewalChurn(), T.RenewalChurn())):
        jw, tw = jav.windows(4, 0), tav.windows(4, 0)
        for c in range(4):
            for t in np.linspace(0.0, 900.0, 31):
                on_j = jw.on_time(c, float(t), float(t) + 1e-3) > 0
                on_t = tw.on_time(c, float(t), float(t) + 1e-3) > 0
                assert on_j == on_t, (type(tav).__name__, c, t)
    for jav, tav in ((J.Churn(), T.Churn()),
                     (J.RegionalChurn(), T.RegionalChurn())):
        with pytest.raises(ValueError) as want:
            jav.windows(4, 0)
        with pytest.raises(ValueError) as got:
            tav.windows(4, 0)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", PRESETS)
def test_host_views_match_reference(name):
    """``host_update_ticks`` / ``host_broadcast_ticks`` / ``host_avail``
    (the host cohort engine's numpy reads of the plan's draws) against
    the reference's, bit for bit, across availability epochs."""
    dt = 0.7
    jp, tp = _plans(name, dt)
    rng = np.random.default_rng(0)
    for _ in range(4):
        i = rng.integers(0, 50, C)
        assert np.array_equal(jp.host_update_ticks(i),
                              tp.host_update_ticks(i))
    for k in (1, 2, 9, 40):
        assert np.array_equal(jp.host_broadcast_ticks(k),
                              tp.host_broadcast_ticks(k))
    for t in (1, 2, 90, 91, 500, 2000, 2001):
        a, b = jp.host_avail(t), tp.host_avail(t)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b), t
