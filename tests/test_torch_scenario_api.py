"""The scenario API's last gaps against the reference: ``LatencyTable``'s
``mean`` / ``quantile`` / ``max_s`` / ``alias_arrays`` and
``scenarios.implied_probs`` on every preset's tables, the availability
models' ``event_supported`` field, ``UpdateBuckets.add`` and
``ScenarioPlan.fingerprint``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.scenarios as ref_sc
from repro.cohort.state import UpdateBuckets as RefBuckets
from repro_torch import scenarios as sc
from repro_torch.cohort.state import UpdateBuckets

PRESETS = sorted(ref_sc.scenario_names())
MODELS = ("AlwaysOn", "Diurnal", "Churn", "RegionalChurn", "RenewalChurn")


def test_api_names_match_the_reference():
    assert sorted(sc.scenario_names()) == PRESETS
    assert set(ref_sc.__all__) <= set(sc.__all__)


@pytest.mark.parametrize("name", PRESETS)
def test_table_stats_and_alias_arrays_match(name):
    ours = sc.get_scenario(name).tables
    ref = ref_sc.get_scenario(name).tables
    assert len(ours) == len(ref)
    for t, r in zip(ours, ref):
        assert t.mean() == r.mean()
        assert t.max_s == r.max_s
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert t.quantile(q) == r.quantile(q)
        prob, alias = t.alias_arrays()
        rprob, ralias = r.alias_arrays()
        assert prob.dtype == np.float32 and alias.dtype == np.int32
        np.testing.assert_array_equal(prob, rprob)
        np.testing.assert_array_equal(alias, ralias)
        implied = sc.implied_probs(prob, alias)
        np.testing.assert_array_equal(implied,
                                      ref_sc.implied_probs(rprob, ralias))
        # the decode-side invariant: exact alias sampling gives probs
        np.testing.assert_allclose(implied, t.probs, atol=1e-6)


def test_table_stats_on_constructed_tables():
    for args in ((1.0, 200.0, 16), (0.5, 3.0, 4)):
        t = sc.LatencyTable.from_uniform(*args)
        r = ref_sc.LatencyTable.from_uniform(*args)
        assert (t.mean(), t.quantile(0.5), t.max_s) == \
            (r.mean(), r.quantile(0.5), r.max_s)
    t = sc.LatencyTable.constant(0.25)
    assert t.mean() == t.quantile(0.3) == t.max_s == 0.25


@pytest.mark.parametrize("model", MODELS)
def test_event_supported_matches_the_reference(model):
    ours, ref = getattr(sc, model)(), getattr(ref_sc, model)()
    assert ours.event_supported == ref.event_supported
    assert "event_supported" in {f.name for f in dataclasses.fields(ours)}
    # the field says whether the event simulator can take the model
    if not ours.event_supported:
        with pytest.raises(ValueError):
            ours.windows(4, 0)
    else:
        ours.windows(4, 0)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_availability_event_supported(name):
    assert sc.get_scenario(name).availability.event_supported == \
        ref_sc.get_scenario(name).availability.event_supported


def test_update_buckets_add_matches_the_reference():
    rng = np.random.default_rng(0)
    vecs = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    calls = [(3, 0, [(0, 1, 0)], False), (3, 1, [(0, 2, 0)], False),
             (9, 2, [(1, 0, 1)], True), (3, 3, [(1, 3, 1)], True)]
    ours, ref = UpdateBuckets(), RefBuckets()
    for tick, i, pairs, far in calls:
        ours.add(tick, torch.from_numpy(vecs[i]), list(pairs), far=far)
        ref.add(tick, vecs[i], list(pairs), far=far)
    assert ours.meta == ref.meta
    assert len(ours) == 4
    for far in (False, True):
        a = ours.far_contrib if far else ours.contrib
        b = ref.far_contrib if far else ref.contrib
        assert sorted(a) == sorted(b)
        for tick in a:
            np.testing.assert_array_equal(a[tick].numpy(), b[tick])
    far, near, meta = ours.pop(3)
    np.testing.assert_array_equal(near.numpy(), vecs[0] + vecs[1])
    np.testing.assert_array_equal(far.numpy(), vecs[3])
    assert meta == [(0, 1, 0), (0, 2, 0), (1, 3, 1)]


@pytest.mark.parametrize("name", PRESETS)
def test_plan_fingerprint(name):
    scn = sc.get_scenario(name)
    plan = sc.ScenarioPlan(scn, C=6, seed=3, dt=4.0, device="cpu")
    ref = ref_sc.ScenarioPlan(ref_sc.get_scenario(name), C=6, seed=3,
                              dt=4.0).fingerprint()
    fp = plan.fingerprint()
    hash(fp)
    assert fp == (scn, 4.0)
    assert (fp[0].name, fp[1]) == (ref[0].name, ref[1])
    assert sc.ScenarioPlan(scn, C=6, seed=3, dt=4.0,
                           device="cpu").fingerprint() == fp
    assert sc.ScenarioPlan(scn, C=6, seed=3, dt=2.0,
                           device="cpu").fingerprint() != fp
    # the event simulator's plan (no dt)
    assert sc.ScenarioPlan(scn, C=6, seed=3,
                           device="cpu").fingerprint() == (scn, None)
