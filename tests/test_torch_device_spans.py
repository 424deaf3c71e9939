"""The device cohort engine's spans, counters and launch record
(``DeviceCohortEngine.spans``), on the CPU with the plain kernels.

Every tick has one integer phase and one host read; the client block,
clip-and-noise, deliver and ring-scatter spans follow the op census; the
model path's steps number C x ``b_stat`` x block ticks; the launch record
follows the census too; and a run with the recorder on is bit for bit the
run with it off, which makes no span, no CUDA event and no allocator
read.
"""
from collections import Counter

import pytest
import torch

import repro_torch as rt
from repro_torch.cohort import DeviceCohortSimulator
from repro_torch.configs import get_config, reduced
from repro_torch.core import BatchModelTask
from repro_torch.data import SeedAddressedBatcher
from repro_torch.models import init_params
from repro_torch.telemetry import SpanRecorder
from repro_torch.telemetry.costs import ops_dict


def _logreg(scenario="mobile_diurnal", strategy=None, dp_rng="operand",
            **kw):
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    task = rt.LogRegTask(X, y, l2=1.0 / 300, sample_seed=21, dp_clip=1.0,
                         dp_sigma=1.5)
    args = dict(n_clients=6, sizes_per_client=[4, 6, 8],
                round_stepsizes=[0.1, 0.08, 0.06], d=2, seed=2, block=4,
                scenario=scenario, strategy=strategy, dp_rng=dp_rng,
                device="cpu")
    args.update(kw)
    return rt.make_simulator("device", task, **args)


def _model(**kw):
    cfg = reduced(get_config("gemma-2b"), n_layers=1, d_model=32, vocab=64)
    params = init_params(cfg, rt.prng.PRNGKey(0), torch.float32,
                         device="cpu")
    batcher = SeedAddressedBatcher(cfg, batch_size=2, seq_len=8, seed=3,
                                   device="cpu")
    task = BatchModelTask(cfg, params, batcher, dp_clip=0.5, dp_sigma=1.0)
    return DeviceCohortSimulator(
        task, n_clients=2, sizes_per_client=[[1, 2]] * 2,
        round_stepsizes=[0.1, 0.08], d=1, seed=5, speeds=[1.0, 1.3],
        block=2, dp_round_clip=1.0, device="cpu", **kw)


def _census(engine):
    return ops_dict(engine.local_state.ops)


def _children(rec, span):
    return [s["name"] for s in rec.spans if s["parent"] == span["id"]]


CASES = {"uniform": dict(scenario="uniform"),
         "mobile_diurnal+fedasync": dict(strategy="fedasync"),
         "iot_straggler+fedbuff": dict(scenario="iot_straggler",
                                       strategy="fedbuff")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tick_spans_follow_the_census(case):
    sim = _logreg(**CASES[case])
    rec = SpanRecorder(device="cpu")
    sim.engine.spans = rec
    sim.run(max_rounds=3)
    ops, n = _census(sim.engine), rec.counts
    ticks = [s for s in rec.spans if s["name"] == "tick"]
    assert len(ticks) == ops["ticks"] > 0
    assert [s["t"] for s in ticks] == list(range(1, ops["ticks"] + 1))
    segs = {s["id"] for s in rec.spans if s["name"] == "segment"}
    for tick in ticks:
        kids = Counter(_children(rec, tick))
        assert kids["tick.integer"] == 1 and kids["tick.read"] == 1
        assert kids["server_step"] == 1
        assert tick["parent"] in segs
        assert set(tick["args"]) == {"t", "fused"}
    for s in rec.spans:             # a tick's spans share its t
        if s["name"] not in ("segment", "tick"):
            assert s["t"] is not None
    assert n["client_block"] == ops["block_ticks"]
    assert n["clip_noise"] == n["ring_scatter"] == ops["complete_ticks"]
    assert n.get("deliver", 0) == ops["deliver_ticks"]
    assert n["noise_draw"] == n["clip_noise_kernel"] == ops["complete_ticks"]
    # fused ticks: the second of an iteration
    fused = sum(s["args"]["fused"] for s in ticks)
    loops, _ = sim.engine.fused_iters
    assert fused == ops["ticks"] - loops
    # the launch record, by kernel
    launched = Counter(k for k, _ in rec.launches)
    assert launched["server_apply"] == ops["ticks"]
    assert launched["tick_deliver"] == ops["deliver_ticks"]
    assert launched["tick_scatter_rows"] == ops["complete_ticks"]
    assert launched["tick_scatter_finish"] == ops["complete_ticks"]
    assert launched["cohort_clip_noise"] == ops["complete_ticks"]
    # a CPU recorder takes no device time and no allocator counters
    assert not any("device_s" in s or s["counters"] for s in rec.spans)


def test_in_kernel_noise_has_no_draw_span():
    sim = _logreg(dp_rng="in_kernel")
    rec = sim.engine.spans = SpanRecorder(device="cpu")
    sim.run(max_rounds=2)
    ops = _census(sim.engine)
    assert "noise_draw" not in rec.counts
    assert rec.counts["clip_noise_kernel"] == ops["complete_ticks"]
    assert Counter(k for k, _ in rec.launches)["cohort_clip_noise_prng"] \
        == ops["complete_ticks"]


def test_model_path_steps():
    sim = _model()
    rec = sim.engine.spans = SpanRecorder(device="cpu")
    assert sim.engine.ltask.spans is rec
    sim.run(max_rounds=2)
    eng, ops = sim.engine, _census(sim.engine)
    n = rec.counts
    assert n["client_block"] == ops["block_ticks"] > 0
    assert n["step"] == eng.C * eng.b_stat * ops["block_ticks"]
    assert n["batch"] == n["loss_and_grad"] == n["update"] == n["step"]
    assert n["client_block.clone"] == ops["block_ticks"]
    assert n["client_block.writeback"] == eng.C * ops["block_ticks"]
    by_id = {s["id"]: s for s in rec.spans}
    for s in rec.spans:
        if s["name"] == "step":
            assert by_id[s["parent"]]["name"] == "client_block"
            assert sorted(_children(rec, s)) == [
                "batch", "loss_and_grad", "update"]
    eng.spans = None
    assert eng.ltask.spans is None and eng.axis.spans is None


def _state(engine):
    return [t.clone() for t in engine.local_state]


@pytest.mark.parametrize("dp_rng", ["operand", "in_kernel"])
def test_recorder_on_and_off_bitwise(dp_rng):
    """The state and the report (but its wall seconds) are bit for bit
    the same with the recorder on and off."""
    out = {}
    for on in (False, True):
        sim = _logreg(strategy="fedasync", dp_rng=dp_rng)
        if on:
            sim.engine.spans = SpanRecorder(device="cpu")
        res = sim.run(max_rounds=3)
        rep = res["telemetry"].to_dict()
        rep.pop("wall")
        out[on] = (_state(sim.engine), rep, res["final"])
    for a, b in zip(out[False][0], out[True][0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out[False][1] == out[True][1]
    assert out[False][2] == out[True][2]


def test_model_path_on_and_off_bitwise():
    torch.use_deterministic_algorithms(True)
    try:
        states = []
        for on in (False, True):
            sim = _model()
            if on:
                sim.engine.spans = SpanRecorder(device="cpu")
            sim.run(max_rounds=2)
            states.append(_state(sim.engine))
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*states):
        assert torch.equal(a, b)


def test_off_makes_no_span(monkeypatch):
    """With ``spans`` None (the default) the tick makes no span, no CUDA
    event and no allocator read, on the logistic and the model path."""
    def refuse(*a, **k):
        raise AssertionError("the recorder is off")

    monkeypatch.setattr(SpanRecorder, "phase", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "memory_stats", refuse)
    for sim in (_logreg(), _model()):
        assert sim.engine.spans is None
        sim.engine.segment(2, 12)
        assert _census(sim.engine)["block_ticks"] > 0
