"""The program's own spans as the benchmark reads them
(``fedbench/program_spans.py`` and the metrics that use it): one recorder
shared by the readers and taken off the engine after the window; the
program's launch record against the benchmark's probe; each idle
nanosecond under the innermost span over it, the parts adding up to the
device's idle share; nothing to read from a program without spans."""
import importlib
from collections import Counter

import pytest
import torch

from _small import LOGREG, MAMBA2
from fedbench import harness, probes, program_spans, traffic
from fedbench.trace import DeviceTrace

IDLE = ("idle_in_client_block", "idle_in_noise", "idle_in_tick_host")


def _metric(name):
    return importlib.import_module(f"fedbench.metrics.{name}")


def _bench(workload, overrides, seed=7):
    c = harness.cell(workload)
    cfg = {**c["config"], **overrides.get("config", {})}
    traf = {**c["traffic"], **overrides.get("traffic", {})}
    proto = traffic.read(traf)
    task = importlib.import_module(f"fedbench.tasks.{cfg['task']}")
    return task.build(cfg, proto, seed, torch.device("cpu")), proto


@pytest.mark.parametrize("workload,overrides,noise", [
    ("logreg_fig1b_dp", LOGREG, "cohort_clip_noise"),
    ("mamba2_fl_dp", MAMBA2, "cohort_clip_noise_prng")])
def test_program_launch_record_equals_the_probes(workload, overrides, noise):
    bench, proto = _bench(workload, overrides)
    eng, ctx = bench.engine, {}
    undo = [probes.install_launches(eng, ctx),
            program_spans.install(eng, ctx)]
    eng.segment(harness.NO_TARGET, proto.warm_ticks + proto.window_ticks)
    for u in reversed(undo):
        u()
    assert eng.spans is None
    rec = ctx[program_spans.KEY]
    kernels = Counter(k for k, _ in rec.launches)
    assert kernels[noise] > 0 and kernels["tick_scatter_rows"] > 0
    assert kernels["server_apply"] == rec.counts["tick"]
    assert harness._host_args(rec.launches) == \
        harness._host_args(ctx["launches"])


def test_install_is_shared_and_undone():
    bench, _ = _bench("logreg_fig1b_dp", LOGREG)
    eng, ctx = bench.engine, {}
    undo = [_metric(m).install(eng, ctx) for m in IDLE
            + ("allocator_calls_per_tick", "flat_adapter_share")]
    rec = ctx[program_spans.KEY]
    assert eng.spans is rec and eng.axis.spans is rec
    for u in undo[:-1]:
        u()
        assert eng.spans is rec
    undo[-1]()
    assert eng.spans is None and ctx[program_spans.KEY] is rec


class _Op:
    """A kineto device event."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def duration_ns(self):
        return self.b - self.a

    def name(self):
        return "kernel"

    def device_type(self):
        return "DeviceType.CUDA"


_ID = iter(range(10 ** 6))


def _span(name, a, b, parent=None, t=None, counters=None, **more):
    return dict(name=name, start_ns=a, end_ns=b, id=next(_ID),
                parent=None if parent is None else parent["id"], t=t,
                counters=counters or {}, **more)


def _synthetic():
    """A 1000 ns window: the device busy over [5, 50], [110, 120],
    [300, 420], [450, 700], [950, 995]; one segment of two ticks."""
    seg = _span("segment", 10, 990)
    t1 = _span("tick", 20, 500, seg, 1, {"num_device_alloc": 3,
                                         "num_device_free": 1})
    cb = _span("client_block", 150, 400, t1, 1, device_s=0.4)
    step = _span("step", 160, 390, cb, 1)
    cn = _span("clip_noise", 410, 480, t1, 1)
    t2 = _span("tick", 510, 980, seg, 2, {"num_device_alloc": 1,
                                          "num_device_free": 1,
                                          "num_alloc_retries": 1})
    spans = [_span("tick.integer", 20, 100, t1, 1),
             _span("tick.read", 100, 120, t1, 1),
             _span("loss_and_grad", 170, 380, step, 1, device_s=0.3),
             step, cb, _span("noise_draw", 410, 440, cn, 1), cn, t1,
             _span("tick.integer", 510, 600, t2, 2), t2, seg]
    ops = [_Op(a, b) for a, b in ((5, 50), (110, 120), (300, 420),
                                  (450, 700), (950, 995))]
    from repro_torch.telemetry import SpanRecorder
    rec = SpanRecorder()
    rec.spans = spans
    return {"trace": DeviceTrace(ops, (0, 1000)), program_spans.KEY: rec}


def test_idle_split_by_overlap(capsys):
    """Each idle nanosecond under the innermost span over it: the gap
    [120, 300] is 30 ns of the tick's own time and 150 ns of the client
    block (its own, its step's and the gradient's); [420, 450] is 20 ns
    of the noise draw and 10 of the clip and noise; the window's edges
    are under no span.  The parts add up to ``device_idle_share``."""
    ctx = _synthetic()
    split = program_spans.idle_split(ctx)
    assert split == {"client_block": 150, "noise": 30, "tick_host": 340,
                     "outside": 10}
    got = {m: _metric(m).read(ctx) for m in IDLE}
    assert got == pytest.approx({"idle_in_client_block": 15.0,
                                 "idle_in_noise": 3.0,
                                 "idle_in_tick_host": 34.0})
    idle = _metric("device_idle_share").read(ctx)
    assert idle == pytest.approx(53.0)
    assert sum(got.values()) + 1.0 == pytest.approx(idle)
    err = capsys.readouterr().err
    # the longest gap, [700, 950], under the second tick's own time
    first = [ln for ln in err.splitlines() if " gap " in ln][0]
    assert "100.0% under segment/tick (t 2), tick: num_device_alloc 1, " \
        "num_device_free 1, num_alloc_retries 1" in first
    assert "outside every span" in err


def test_counters_and_device_times():
    ctx = _synthetic()
    assert _metric("allocator_calls_per_tick").read(ctx) == 3.0
    assert _metric("flat_adapter_share").read(ctx) == pytest.approx(25.0)


def test_nothing_to_read_without_program_spans():
    """A program whose engine takes no recorder (the parent of the
    change that added it): install does nothing and every reader finds
    nothing, without raising."""
    class Engine:
        device = torch.device("cpu")

    ctx = {"trace": _synthetic()["trace"]}
    eng = Engine()
    for m in IDLE + ("allocator_calls_per_tick", "flat_adapter_share"):
        _metric(m).install(eng, ctx)()
        assert _metric(m).read(ctx) is None
    assert not hasattr(eng, "spans") and program_spans.KEY not in ctx
