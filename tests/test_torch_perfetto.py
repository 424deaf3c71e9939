"""The port's span recorder and Perfetto export
(``repro_torch.telemetry.spans``, ``python -m repro_torch.telemetry``)
against the reference's (``repro.telemetry``).

Twins of ``tests/test_telemetry.py``'s span and Perfetto tests, plus:
on the same JSONL records (the port's three engines, on the CPU) the
port's ``trace_to_perfetto`` is JSON-equal to the reference's — pids,
tids, flow ids, ``ts``, ``dur``, ``args``; ``validate_trace_events``
rejects the same malformed documents with the same problems; torch and
numpy values reach the file as plain JSON numbers; ``annotate=True``
spans show up in a ``torch.profiler`` trace; the CLI's ``capture``
(``--device cpu``) and ``convert`` write valid documents, and
``convert`` writes the reference's document.
"""
import copy
import io
import json

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.telemetry import spans as ref_spans
from repro_torch.telemetry import (JsonlTraceWriter, SpanRecorder,
                                   maybe_span, trace_to_perfetto,
                                   validate_trace_events, write_perfetto)
from repro_torch.telemetry.__main__ import main, timeline
from repro_torch.telemetry.spans import _EventBuilder, merge_trace_events


def _task(n=300, d=12, seed=9, sample_seed=21, **kw):
    X, y = rt.make_binary_dataset(n, d, seed=seed, noise=0.3)
    return rt.LogRegTask(X, y, l2=1.0 / n, sample_seed=sample_seed, **kw)


_KW = dict(n_clients=4, sizes_per_client=[4, 6], round_stepsizes=[0.1, 0.08],
           d=1, seed=0, device="cpu")


def _records(buf):
    return [json.loads(line) for line in buf.getvalue().strip().splitlines()]


def _run(engine, rounds=2, **kw):
    """-> (simulator, result, JSONL records) of a small port run."""
    buf = io.StringIO()
    args = dict(_KW, **kw)
    if engine != "event":
        args.setdefault("block", 4)
    sim = rt.make_simulator(engine, _task(dp_clip=1.0, dp_sigma=1.5),
                            trace=buf, **args)
    res = sim.run(max_rounds=rounds, eval_every=1)
    return sim, res, _records(buf)


@pytest.fixture(scope="module")
def runs():
    return {e: _run(e, scenario="mobile_diurnal", d=2)
            for e in ("event", "cohort", "device")}


# --- span recorder -----------------------------------------------------------

def test_phase_timer_accumulates():
    t = SpanRecorder()
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts["a"] == 2 and t.counts["b"] == 1
    d = t.as_dict()
    # seconds per phase plus span counts (SpanRecorder.as_dict)
    assert set(d) == {"a_s", "b_s", "a_n", "b_n"}
    assert all(v >= 0 for v in d.values())
    assert d["a_n"] == 2 and d["b_n"] == 1


def test_span_recorder_tracks_and_trace_events():
    rec = SpanRecorder()
    with rec.phase("steady", seg=1):
        pass
    with rec.phase("steady", seg=2):
        pass
    rec.add("compile", 0.25)
    events = rec.to_trace_events()
    doc = {"traceEvents": events}
    assert validate_trace_events(doc) == []
    slices = [e for e in events if e["ph"] == "X"]
    assert len(slices) == 3
    assert {e["name"] for e in slices} == {"steady", "compile"}
    # re-entrant phases stay on one track, back to back, not stacked
    assert len({(e["pid"], e["tid"]) for e in slices
                if e["name"] == "steady"}) == 1


def test_span_recorder_events_equal_the_reference():
    """The same spans render to the reference's events (the builder's
    pid/tid allocation and metadata), with plain JSON args."""
    spans = [dict(name="steady", track="steady", t0=0.0, dur=0.5,
                  args={"seg": 1}),
             dict(name="eval", track="eval", t0=0.5, dur=0.25, args={}),
             dict(name="steady", track="steady", t0=0.75, dur=0.5,
                  args={"seg": 2})]
    ours, ref = SpanRecorder(), ref_spans.SpanRecorder()
    ours.spans = copy.deepcopy(spans)
    ref.spans = copy.deepcopy(spans)
    assert ours.to_trace_events(process="wall") == \
        ref.to_trace_events(process="wall")


def test_annotate_brackets_spans_in_the_torch_profiler():
    """``annotate=True``: each span is a ``record_function`` range of
    the same name in a ``torch.profiler`` trace."""
    rec = SpanRecorder(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.phase("steady"):
            torch.ones(8) @ torch.ones(8)
        with rec.phase("eval"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"steady", "eval"} <= names
    assert rec.counts == {"steady": 1, "eval": 1}


def test_span_clock_is_the_profilers():
    """A span's ``time.time_ns()`` edges contain the kineto event of the
    torch operation it brackets: the host spans and a ``torch.profiler``
    trace share one clock."""
    rec = SpanRecorder()
    x = torch.randn(256, 256)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.phase("matmul"):
            x @ x
    (span,) = rec.spans
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span["start_ns"] <= mm[0].start_ns()
    assert mm[0].end_ns() <= span["end_ns"]
    # the epoch seconds are kept beside the absolute edges
    assert span["dur"] == pytest.approx(
        (span["end_ns"] - span["start_ns"]) / 1e9, abs=1e-4)


def test_span_parent_tick_self_time_and_counters():
    rec = SpanRecorder()
    with rec.phase("segment"):
        with rec.phase("tick", t=7, fused=False):
            with rec.phase("tick.integer"):
                rec.count("launches", 3)
            rec.count("launches")
            with rec.phase("server_step"):
                pass
        rec.count("ticks")
    rec.count("nothing open")            # no span open: not counted
    by = {s["name"]: s for s in rec.spans}
    assert [s["name"] for s in rec.spans] == [
        "tick.integer", "server_step", "tick", "segment"]
    assert by["segment"]["parent"] is None
    assert by["tick"]["parent"] == by["segment"]["id"]
    assert by["tick.integer"]["parent"] == by["tick"]["id"]
    # the tick's identifier is shared by its children, not its parent
    assert by["tick"]["t"] == by["tick.integer"]["t"] == \
        by["server_step"]["t"] == 7
    assert by["segment"]["t"] is None
    assert by["tick"]["args"] == {"t": 7, "fused": False}
    assert by["tick.integer"]["counters"] == {"launches": 3}
    assert by["tick"]["counters"] == {"launches": 1}
    assert by["segment"]["counters"] == {"ticks": 1}
    selfs = rec.self_seconds()
    assert selfs[by["tick"]["id"]] == pytest.approx(
        by["tick"]["dur"] - by["tick.integer"]["dur"]
        - by["server_step"]["dur"])
    assert selfs[by["server_step"]["id"]] == by["server_step"]["dur"]
    for s in rec.spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = next(q for q in rec.spans if q["id"] == s["parent"])
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    # the parent's name and the tick reach the slices' args
    ev = {e["name"]: e for e in rec.to_trace_events() if e["ph"] == "X"}
    assert ev["tick.integer"]["args"] == {"parent": "tick", "t": 7}
    assert ev["tick"]["args"] == {"t": 7, "fused": False,
                                  "parent": "segment"}
    assert ev["segment"]["args"] == {}


class _FakeEvent:
    """A CUDA event on the host's clock."""

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        import time
        self.at = time.perf_counter()

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


def test_device_spans_resolve_and_allocator_counters(monkeypatch):
    """On a CUDA recorder, ``device=True`` records an event pair resolved
    only by ``resolve()``, and ``alloc=True`` counts the allocator's
    deltas over the span; on a CPU recorder both flags do nothing."""
    stats = dict.fromkeys(SpanRecorder.ALLOC_STATS, 0)

    def memory_stats(device=None):
        stats["num_device_alloc"] += 1      # one per read
        return dict(stats)

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    rec = SpanRecorder(device="cuda")
    with rec.phase("client_block", device=True, alloc=True):
        with rec.phase("loss_and_grad", device=True):
            stats["num_device_free"] += 2
            stats["num_alloc_retries"] += 1
    by = {s["name"]: s for s in rec.spans}
    assert "device_s" not in by["client_block"]
    rec.resolve()
    assert by["client_block"]["device_s"] >= by["loss_and_grad"]["device_s"]
    assert by["loss_and_grad"]["device_s"] >= 0
    assert by["client_block"]["counters"] == {
        "num_device_alloc": 1, "num_device_free": 2,
        "num_alloc_retries": 1, "num_sync_all_streams": 0}
    assert by["loss_and_grad"]["counters"] == {}
    rec.resolve()                               # idempotent
    cpu = SpanRecorder(device="cpu")
    with cpu.phase("client_block", device=True, alloc=True):
        pass
    cpu.resolve()
    assert "device_s" not in cpu.spans[0] and cpu.spans[0]["counters"] == {}
    assert stats["num_device_alloc"] == 2       # the CPU read nothing


def test_maybe_span_off_is_one_shared_no_op():
    assert maybe_span(None, "tick") is maybe_span(None, "client_block",
                                                  device=True, alloc=True)
    with maybe_span(None, "tick"):
        with maybe_span(None, "tick"):          # re-entrant
            pass
    rec = SpanRecorder()
    with maybe_span(rec, "tick", t=1):
        pass
    assert rec.counts == {"tick": 1}


def test_engine_reports_carry_wall_phases(runs):
    assert "first_segment_s" in runs["device"][1]["telemetry"].wall
    assert runs["event"][1]["telemetry"].wall["run_s"] > 0


# --- Perfetto export ---------------------------------------------------------

def test_perfetto_event_trace_has_flows(tmp_path):
    """Event-sim JSONL -> Perfetto: message lifecycles become flow
    events on virtual-protocol time and the doc validates + round-trips
    through json.load."""
    _, res, records = _run("event", scenario="uniform")
    events = trace_to_perfetto(records)
    out = tmp_path / "trace.json"
    write_perfetto(str(out), events)
    with open(out) as fh:
        doc = json.load(fh)
    assert validate_trace_events(doc) == []
    phs = {e["ph"] for e in doc["traceEvents"]}
    assert {"s", "f", "i", "M"} <= phs          # flows + instants
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "f")]
    assert len(flows) >= 2 * res["telemetry"].messages


def test_perfetto_device_trace_segments():
    """Device-engine JSONL (segment summaries) -> Perfetto slices on
    the virtual clock, plus the run's wall spans, in one document."""
    sim, _, records = _run("device", rounds=3, scenario="uniform")
    events = trace_to_perfetto(records)
    events += sim.engine.timer.to_trace_events(process="wall")
    # two processes may share builder-less ids; validate separately
    assert validate_trace_events({"traceEvents": events},
                                 check_overlap=False) == []
    seg_slices = [e for e in events
                  if e["ph"] == "X" and e.get("args", {}).get("ops")]
    assert seg_slices, "segment slices should carry op-census args"
    # through one builder (the CLI's timeline) the tracks are disjoint
    doc = timeline(records, sim.engine.timer)
    assert validate_trace_events(doc) == []


@pytest.mark.parametrize("engine", ["event", "cohort", "device"])
def test_virtual_clock_events_equal_the_reference(runs, engine):
    """Same records -> JSON-equal virtual-clock events: pids, tids,
    flow ids, ts, dur and args."""
    records = runs[engine][2]
    assert records
    ours = trace_to_perfetto(copy.deepcopy(records))
    ref = ref_spans.trace_to_perfetto(copy.deepcopy(records))
    assert json.dumps(ours, sort_keys=True) == \
        json.dumps(ref, sort_keys=True)
    # and through a builder shared with the wall process
    b, rb = _EventBuilder(), ref_spans._EventBuilder()
    trace_to_perfetto(copy.deepcopy(records), b)
    ref_spans.trace_to_perfetto(copy.deepcopy(records), rb)
    assert b.events == rb.events


def test_torch_and_numpy_values_become_plain_numbers(tmp_path):
    """Records and span args carrying 0-d tensors, tensors and numpy
    scalars are written as plain JSON numbers, equal to the document
    of the plain records."""
    plain = [{"kind": "segment", "engine": "device", "round": 2, "tick": 7,
              "time": 3.5, "messages": 12, "staleness_hist": [9, 3, 0],
              "overflow_hwm": 0, "ops": [7, 2]},
             {"kind": "report", "engine": "device", "messages": 12,
              "virtual_time": 3.5}]
    mixed = copy.deepcopy(plain)
    mixed[0].update(round=torch.tensor(2), tick=np.int64(7),
                    time=torch.tensor(3.5, dtype=torch.float64),
                    messages=np.int32(12),
                    staleness_hist=torch.tensor([9, 3, 0],
                                                dtype=torch.int32),
                    ops=np.array([7, 2], np.int32))
    mixed[1]["messages"] = torch.tensor(12)
    want = trace_to_perfetto(plain)
    got = trace_to_perfetto(mixed)
    assert json.dumps(got) == json.dumps(want)
    rec = SpanRecorder()
    with rec.phase("steady", seg=torch.tensor(1), n=np.int64(2)):
        pass
    out = tmp_path / "t.json"
    write_perfetto(str(out), rec.to_trace_events())
    doc = json.loads(out.read_text())
    sl = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sl[0]["args"] == {"seg": 1, "n": 2}
    # the JSONL writer takes the same values
    buf = io.StringIO()
    w = JsonlTraceWriter(buf)
    w.emit("x", a=torch.tensor(3), b=torch.arange(2), c=np.float32(0.5),
           e=np.int64(4))
    w.close()
    assert json.loads(buf.getvalue()) == \
        {"kind": "x", "a": 3, "b": [0, 1], "c": 0.5, "e": 4}


# --- validation --------------------------------------------------------------

_BAD_DOCS = {
    "not_a_doc": [1, 2],
    "no_list": {"traceEvents": {}},
    "not_an_object": {"traceEvents": [3]},
    "unknown_ph": {"traceEvents": [{"ph": "Q", "name": "a", "pid": 1,
                                    "tid": 1, "ts": 0}]},
    "missing_dur": {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                     "tid": 1, "ts": 0}]},
    "missing_id": {"traceEvents": [{"ph": "s", "name": "a", "pid": 1,
                                    "tid": 1, "ts": 0}]},
    "negative_ts": {"traceEvents": [{"ph": "i", "name": "a", "pid": 1,
                                     "tid": 1, "ts": -1}]},
    "string_ts": {"traceEvents": [{"ph": "i", "name": "a", "pid": 1,
                                   "tid": 1, "ts": "0"}]},
    "negative_dur": {"traceEvents": [{"ph": "X", "name": "a", "pid": 1,
                                      "tid": 1, "ts": 0, "dur": -2}]},
    "overlap": {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0, "dur": 5},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 3, "dur": 3}]},
}


@pytest.mark.parametrize("name", sorted(_BAD_DOCS))
def test_validate_rejects_what_the_reference_rejects(name):
    doc = _BAD_DOCS[name]
    got = validate_trace_events(copy.deepcopy(doc))
    assert got, "a malformed document must not validate"
    assert got == ref_spans.validate_trace_events(copy.deepcopy(doc))


def test_write_perfetto_rejects_malformed(tmp_path):
    bad = [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0}]
    with pytest.raises(ValueError):
        write_perfetto(str(tmp_path / "bad.json"), bad)


def test_merge_trace_events_wraps_lists():
    doc = merge_trace_events([{"a": 1}], [{"b": 2}])
    assert doc == ref_spans.merge_trace_events([{"a": 1}], [{"b": 2}])


# --- CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["event", "device"])
def test_telemetry_cli_capture_and_convert(tmp_path, engine):
    """ONE CLI invocation produces a Perfetto-loadable trace JSON;
    ``convert`` of its JSONL equals the reference's ``convert``."""
    from repro.telemetry.__main__ import main as ref_main
    out = tmp_path / "timeline.json"
    jl = tmp_path / "run.jsonl"
    argv = ["capture", "--engine", engine, "--rounds", "2", "--clients",
            "4", "--out", str(out), "--jsonl-out", str(jl), "--device",
            "cpu"]
    if engine == "device":
        argv.append("--dp")
    assert main(argv) == 0
    with open(out) as fh:
        doc = json.load(fh)
    assert doc["traceEvents"] and validate_trace_events(doc) == []
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"protocol (virtual)", "wall"}
    out2, out3 = tmp_path / "converted.json", tmp_path / "ref.json"
    assert main(["convert", str(jl), "--out", str(out2)]) == 0
    assert ref_main(["convert", str(jl), "--out", str(out3)]) == 0
    doc2 = json.loads(out2.read_text())
    assert validate_trace_events(doc2) == []
    assert doc2 == json.loads(out3.read_text())


def test_telemetry_cli_capture_profile_one_clock(tmp_path):
    """``capture --profile``: the run under ``torch.profiler`` (CPU
    activity here), its operations a ``device`` process on the spans'
    clock; the document validates, and each tick's integer phase sits
    over the operations it ran."""
    out = tmp_path / "timeline.json"
    assert main(["capture", "--engine", "device", "--rounds", "2",
                 "--clients", "4", "--dp", "--profile", "--out", str(out),
                 "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert validate_trace_events(doc) == []
    pids = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert set(pids) == {"protocol (virtual)", "wall", "device"}
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    dev = [e for e in xs if e["pid"] == pids["device"]]
    wall = [e for e in xs if e["pid"] == pids["wall"]]
    assert dev and {"segment", "tick", "tick.integer", "tick.read",
                    "server_step", "client_block", "clip_noise",
                    "ring_scatter", "first_segment"} <= {
                        e["name"] for e in wall}
    for tick in (e for e in wall if e["name"] == "tick"):
        assert tick["args"]["t"] >= 1 and "parent" in tick["args"]
    for span in (e for e in wall if e["name"] == "tick.integer"):
        a, b = span["ts"], span["ts"] + span["dur"]
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   and e["name"].startswith("aten::") for e in dev)


def test_telemetry_cli_capture_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["capture", "--out", str(tmp_path / "t.json")])
