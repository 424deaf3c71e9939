"""The port's trace invariant checker (``repro_torch.analysis.invariants``)
against the reference's (``repro.analysis.invariants``).

Twins of ``tests/test_invariants.py``: the port's three engines write
their JSONL traces on the CPU at the reference tests' sizes; both
checkers read the same records, clean and with each planted fault, and
must return the same ``(rule, line, message)`` list, with the planted
rule among them.  The port's device-engine records also equal the
reference's, field by field but the wall clock.
"""
import copy
import io
import json

import pytest

import repro_torch as rt
from repro.analysis import invariants as ref_inv
from repro_torch.analysis import invariants as inv
from repro_torch.scenarios import LatencyTable, Scenario
from repro_torch.telemetry import trace_to_perfetto, write_perfetto


def _task(**kw):
    X, y = rt.make_binary_dataset(200, 10, seed=9, noise=0.3)
    return rt.LogRegTask(X, y, l2=0.005, sample_seed=21, **kw)


def _rules(violations):
    return sorted({v.rule for v in violations})


def _found(x):
    return [(v.rule, v.line, v.message) for v in x]


def _both(recs, d):
    """Both checkers on (copies of) the same records; equal findings."""
    got = inv.check_trace(copy.deepcopy(recs), d=d)
    want = ref_inv.check_trace(copy.deepcopy(recs), d=d)
    assert _found(got) == _found(want)
    return got


def _records(buf):
    return [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]


def _event_trace(d=2, **task_kw):
    buf = io.StringIO()
    rt.AsyncFLSimulator(_task(**task_kw), scenario="uniform", trace=buf,
                        n_clients=5, sizes_per_client=[3, 4],
                        round_stepsizes=[0.1, 0.08], d=d, seed=3,
                        device="cpu").run(max_rounds=3)
    return _records(buf)


def _device_records(d=3, scenario="geo_regional", **task_kw):
    buf = io.StringIO()
    rt.DeviceCohortSimulator(_task(**task_kw), scenario=scenario,
                             n_clients=6, sizes_per_client=[3, 4, 5],
                             round_stepsizes=[0.1, 0.08, 0.06], d=d, seed=5,
                             block=4, trace=buf,
                             device="cpu").run(max_rounds=4, eval_every=1)
    return _records(buf)


def _tail_records():
    scn = Scenario("tail", LatencyTable.from_uniform(1.0, 200.0, 16),
                   ring_cap=8)
    buf = io.StringIO()
    res = rt.DeviceCohortSimulator(
        _task(dp_clip=0.1, dp_sigma=2.0), scenario=scn, n_clients=6,
        sizes_per_client=[3, 4], round_stepsizes=[0.1, 0.08], d=2, seed=2,
        block=4, dp_round_clip=0.5, trace=buf,
        device="cpu").run(max_rounds=3, eval_every=1)
    assert res["final"]["overflow_hwm"] > 0    # latch actually moved
    return _records(buf)


@pytest.fixture(scope="module")
def event_recs():
    return _event_trace(d=2)


@pytest.fixture(scope="module")
def device_recs():
    return _device_records(d=3)


@pytest.fixture(scope="module")
def tail_recs():
    return _tail_records()


# --- clean traces model-check clean ------------------------------------------

_ENGINES = {
    "event": lambda: rt.AsyncFLSimulator,
    "cohort": lambda: rt.CohortSimulator,
    "device": lambda: rt.DeviceCohortSimulator,
}


@pytest.mark.parametrize("dp", [False, True], ids=["nodp", "dp"])
@pytest.mark.parametrize("engine", sorted(_ENGINES))
def test_engine_trace_clean(engine, dp):
    """Every port engine's trace, DP on and off, under a stochastic
    scenario at d = 2, is clean under both checkers."""
    kw = dict(dp_clip=1.0, dp_sigma=1.5) if dp else {}
    buf = io.StringIO()
    cls = _ENGINES[engine]()
    extra = {} if engine == "event" else dict(block=4)
    cls(_task(**kw), scenario="mobile_diurnal", n_clients=5,
        sizes_per_client=[3, 4], round_stepsizes=[0.1, 0.08], d=2, seed=7,
        trace=buf, device="cpu", **extra).run(max_rounds=3, eval_every=1)
    recs = _records(buf)
    assert {r["kind"] for r in recs} >= {"report"}
    assert _both(recs, d=2) == []


def test_event_trace_clean(event_recs):
    assert _both(event_recs, d=2) == []


def test_event_trace_with_dp_clean():
    assert _both(_event_trace(d=2, dp_clip=1.0, dp_sigma=1.5), d=2) == []


def test_device_trace_golden_scenario_clean(device_recs, tmp_path):
    """Golden-trajectory-style device run (churny geo_regional, d=3),
    also read from a path by both checkers."""
    assert _both(device_recs, d=3) == []
    p = tmp_path / "device.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in device_recs))
    assert inv.check_trace(str(p), d=3) == []
    assert ref_inv.check_trace(str(p), d=3) == []


def test_device_records_equal_the_reference(device_recs):
    """The same run on the reference's device engine writes the same
    records, field by field, except the wall clock."""
    import repro.core as rc
    from repro.cohort import DeviceCohortSimulator
    from repro.data import make_binary_dataset
    X, y = make_binary_dataset(200, 10, seed=9, noise=0.3)
    buf = io.StringIO()
    DeviceCohortSimulator(rc.LogRegTask(X, y, l2=0.005, sample_seed=21),
                          scenario="geo_regional", n_clients=6,
                          sizes_per_client=[3, 4, 5],
                          round_stepsizes=[0.1, 0.08, 0.06], d=3, seed=5,
                          block=4, trace=buf).run(max_rounds=4,
                                                  eval_every=1)
    ref = _records(buf)
    assert len(ref) == len(device_recs)
    for a, b in zip(device_recs, ref):
        a, b = dict(a), dict(b)
        a.pop("wall", None)
        b.pop("wall", None)
        assert a == b


def test_device_trace_dp_heavy_tail_churn_clean(tail_recs):
    """DP + heavy-tail latency + small ring (far tier + overflow HWM
    exercised) — the richest segment trace the engines emit."""
    assert _both(tail_recs, d=2) == []


def test_host_cohort_trace_clean(tmp_path):
    path = tmp_path / "host.jsonl"
    rt.CohortSimulator(_task(), scenario="mobile_diurnal", n_clients=5,
                       sizes_per_client=[3, 4], round_stepsizes=[0.1, 0.08],
                       d=2, seed=7, block=4, trace=str(path),
                       device="cpu").run(max_rounds=3, eval_every=1)
    assert inv.check_trace(str(path), d=2) == []
    assert _both(inv.read_trace(str(path)), d=2) == []


# --- corrupted JSONL trips each family ---------------------------------------

def test_corrupt_tau_exceeds_gate(event_recs):
    """An apply recorded past the wait gate (τ > d-1) must fire INV-TAU."""
    recs = copy.deepcopy(event_recs)
    applied = [r for r in recs if r["kind"] == "update_applied"]
    applied[0]["staleness"] = 7                # d-1 == 1
    found = _both(recs, d=2)
    assert "INV-TAU" in _rules(found)
    assert any("wait-gate" in v.message for v in found)


def test_corrupt_negative_staleness(event_recs):
    recs = copy.deepcopy(event_recs)
    applied = [r for r in recs if r["kind"] == "update_applied"]
    applied[-1]["staleness"] = -1
    assert "INV-TAU" in _rules(_both(recs, d=2))


def test_corrupt_bytes_census(event_recs):
    """Report bytes_up no longer equal to Σ update_sent bytes."""
    recs = copy.deepcopy(event_recs)
    report = [r for r in recs if r["kind"] == "report"][0]
    report["bytes_up"][0] += 1
    assert "INV-CENSUS" in _rules(_both(recs, d=2))


def test_corrupt_lost_apply_breaks_round_conservation(event_recs):
    """Dropping one update_applied leaves a completed round at C-1
    applies — Algorithm 3's H set can't have filled."""
    recs = copy.deepcopy(event_recs)
    drop = next(i for i, r in enumerate(recs)
                if r["kind"] == "update_applied" and r["round"] == 0)
    del recs[drop]
    assert "INV-ROUND" in _rules(_both(recs, d=2))


def test_corrupt_time_regression(event_recs):
    recs = copy.deepcopy(event_recs)
    events = [r for r in recs if "time" in r]
    events[-1]["time"] = events[0]["time"] - 1.0
    assert "INV-TIME" in _rules(_both(recs, d=2))


def test_corrupt_overflow_latch_regression(tail_recs):
    """The overflow HWM is a latch; a later segment reporting a lower
    mark means the census was rebuilt instead of latched."""
    recs = copy.deepcopy(tail_recs)
    segs = [r for r in recs if r["kind"] == "segment"]
    assert len(segs) >= 2 and segs[-1]["overflow_hwm"] > 0
    segs[-1]["overflow_hwm"] = 0               # regress the latch
    assert "INV-LATCH" in _rules(_both(recs, d=2))


def test_corrupt_segment_counter_regression(device_recs):
    recs = copy.deepcopy(device_recs)
    segs = [r for r in recs if r["kind"] == "segment"]
    segs[-1]["messages"] = segs[0]["messages"] - 1
    assert "INV-MONO" in _rules(_both(recs, d=3))


def test_corrupt_staleness_hist_entrywise_regression(device_recs):
    """Lowered below the PREVIOUS segment's bin, so the regression is
    real whatever the last segment added to that bin."""
    recs = copy.deepcopy(device_recs)
    segs = [r for r in recs if r["kind"] == "segment"]
    assert segs[-2]["staleness_hist"][0] > 0
    segs[-1]["staleness_hist"][0] = segs[-2]["staleness_hist"][0] - 1
    assert "INV-MONO" in _rules(_both(recs, d=3))


# --- report-level checks -----------------------------------------------------

_REPORT = {"clients": 2, "messages": 5, "broadcasts": 2,
           "participation": [3, 2], "update_msg_bytes": 10,
           "broadcast_msg_bytes": 8, "bytes_up": [30, 20],
           "bytes_down": [16, 16], "staleness_hist": [5, 0, 0, 0],
           "overflow_hwm": 1, "overflow_slots": 4}


@pytest.mark.parametrize("change,rule", [
    ({}, None),
    ({"participation": [3, 3]}, "INV-CENSUS"),      # Σ != messages
    ({"staleness_hist": [4, 1, 0, 0]}, "INV-TAU"),  # mass past d-1
    ({"overflow_hwm": 9}, "INV-LATCH"),             # over capacity
    ({"bytes_down": [16, 24]}, "INV-CENSUS"),
], ids=["clean", "participation", "hist", "latch", "bytes_down"])
def test_check_report_census_identities(change, rule):
    rep = dict(_REPORT, **change)
    got = inv.check_report(copy.deepcopy(rep), d=1)
    assert _found(got) == _found(ref_inv.check_report(rep, d=1))
    assert _rules(got) == ([rule] if rule else [])


def test_read_trace_rejects_malformed_lines(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"kind": "report"}\nnot json\n')
    with pytest.raises(ValueError, match="line 2"):
        inv.read_trace(str(p))
    p.write_text('{"no_kind": 1}\n')
    with pytest.raises(ValueError, match="kind"):
        inv.read_trace(str(p))


def test_check_trace_accepts_lines_and_paths(event_recs, tmp_path):
    lines = [json.dumps(r) for r in event_recs]
    assert inv.check_trace(lines, d=2) == []    # iterable of JSONL lines
    p = tmp_path / "t.jsonl"
    p.write_text("\n".join(lines) + "\n")
    assert inv.check_trace(str(p), d=2) == []   # path (where=path)
    assert inv.read_trace(str(p)) == event_recs


# --- op-census + timeline discipline (INV-SPAN) ------------------------------

def test_corrupt_segment_ops_regression(device_recs):
    """Per-segment op-census counters are cumulative; one regressing
    entrywise means an increment site was rebuilt, not accumulated."""
    recs = copy.deepcopy(device_recs)
    segs = [r for r in recs if r["kind"] == "segment"]
    assert segs[0]["ops"][0] > 0                # ticks counted
    segs[-1]["ops"][0] = segs[0]["ops"][0] - 1  # below an earlier segment
    assert "INV-SPAN" in _rules(_both(recs, d=3))


def test_corrupt_report_ops_relations(device_recs):
    """Report op census inconsistent with the message counts fires
    INV-SPAN (complete_ticks cannot exceed messages)."""
    recs = copy.deepcopy(device_recs)
    report = [r for r in recs if r["kind"] == "report"][0]
    report["ops"] = dict(report["ops"],
                         complete_ticks=report["messages"] + 1)
    found = _both(recs, d=3)
    assert "INV-SPAN" in _rules(found)
    assert any("complete_ticks" in v.message for v in found)


_X = {"ph": "X", "pid": 1, "tid": 1}


@pytest.mark.parametrize("events,rules", [
    ([dict(_X, name="a", ts=0, dur=5), dict(_X, name="b", ts=5, dur=3)], []),
    ([dict(_X, name="a", ts=0, dur=5), dict(_X, name="b", ts=3, dur=3)],
     ["INV-SPAN"]),
    ([dict(_X, name="a", ts=0)], ["INV-SPAN"]),
], ids=["ok", "overlapping", "missing_dur"])
def test_check_perfetto_overlap_and_shape(events, rules):
    doc = {"traceEvents": events}
    got = inv.check_perfetto(copy.deepcopy(doc))
    assert _found(got) == _found(ref_inv.check_perfetto(doc))
    assert _rules(got) == rules


def test_check_perfetto_exported_document(event_recs, tail_recs, tmp_path):
    """Path form: documents the port exports check clean under both."""
    for name, recs in (("event", event_recs), ("tail", tail_recs)):
        out = tmp_path / f"{name}.json"
        write_perfetto(str(out), trace_to_perfetto(recs))
        assert inv.check_perfetto(str(out)) == []
        assert ref_inv.check_perfetto(str(out)) == []
