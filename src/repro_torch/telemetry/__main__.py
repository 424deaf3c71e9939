"""``python -m repro_torch.telemetry`` — one-invocation Perfetto timelines.

Two modes:

  * ``capture``: run a small engine workload end-to-end and write a
    Perfetto-loadable trace JSON combining BOTH clocks — the engine's
    wall-clock phase spans (first_segment/steady/eval, from
    ``SpanRecorder``; for the device engine also its tick's spans,
    ``DeviceCohortEngine.spans``) and the virtual-protocol timeline
    reconstructed from the run's JSONL trace (message lifecycles / eval
    segments with op-census counters).  With ``--profile`` the run is
    under ``torch.profiler`` and its device operations join the document
    as a ``device`` process on the spans' clock, so each tick's spans sit
    over the kernels they launched.  It runs on the card; ``--device
    cpu`` runs the plain PyTorch versions of the kernels instead (and
    ``--profile`` then records the CPU's operations).

      PYTHONPATH=src python -m repro_torch.telemetry capture --out trace.json
      PYTHONPATH=src python -m repro_torch.telemetry capture --profile \\
          --out trace.json

  * ``convert``: turn an existing JSONL trace (``trace=`` engine output)
    into the same trace-event JSON.

      PYTHONPATH=src python -m repro_torch.telemetry convert run.jsonl \\
          --out trace.json

Open the result at https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from typing import List, Optional

from repro_torch.telemetry.spans import (SpanRecorder, _EventBuilder,
                                         device_events, merge_trace_events,
                                         trace_to_perfetto, write_perfetto)


def _read_jsonl(fh) -> List[dict]:
    return [json.loads(line) for line in fh if line.strip()]


def timeline(records: List[dict], recorder=None, spans=None,
             device_ops=None, device_type: str = "CUDA") -> dict:
    """One trace-event document from a run's JSONL records and, when
    given, its ``SpanRecorder`` (the run's phases), the engine's span
    recorder and ``torch.profiler``'s events: ONE builder, so the
    virtual, wall and device processes get distinct pids.  With
    ``spans`` or ``device_ops`` every host span and device operation is
    placed on ``time.time_ns()`` from the earliest of them."""
    builder = _EventBuilder()
    trace_to_perfetto(records, builder)
    recs = [r for r in (recorder, spans) if r is not None]
    origin = None
    if spans is not None or device_ops is not None:
        starts = [s["start_ns"] for r in recs for s in r.spans]
        starts += [e.start_ns() for e in device_ops or ()]
        origin = min(starts) if starts else 0
    for r in recs:
        r.to_trace_events(builder, process="wall", origin_ns=origin)
    if device_ops is not None:
        device_events(device_ops, builder, origin_ns=origin,
                      device_type=device_type)
    return merge_trace_events(builder.events)


def _cmd_convert(args) -> int:
    with open(args.trace) as fh:
        records = _read_jsonl(fh)
    doc = timeline(records)
    write_perfetto(args.out, doc)
    print(f"wrote {args.out}: {len(doc['traceEvents'])} trace events from "
          f"{len(records)} records")
    return 0


def _cmd_capture(args) -> int:
    from repro_torch.cohort import make_simulator
    from repro_torch.core import LogRegTask
    from repro_torch.data import make_binary_dataset

    X, y = make_binary_dataset(300, 12, seed=args.seed + 7, noise=0.3)
    task = LogRegTask(X, y, l2=1.0 / 300, sample_seed=21,
                      dp_clip=1.0 if args.dp else 0.0,
                      dp_sigma=1.5 if args.dp else 0.0)
    sink = io.StringIO()
    sim = make_simulator(
        args.engine, task, n_clients=args.clients,
        sizes_per_client=[4, 6, 8],
        round_stepsizes=[0.1, 0.08, 0.06], d=args.d, seed=args.seed,
        scenario=args.scenario, strategy=args.strategy, trace=sink,
        device=args.device)
    engine = getattr(sim, "engine", sim)
    spans = None
    if hasattr(engine, "spans"):
        spans = engine.spans = SpanRecorder(device=engine.device)
    device_ops, device_type = None, "CUDA"
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        if engine.device.type != "cuda":
            device_type = "CPU"
        with profile(activities=[getattr(ProfilerActivity,
                                         device_type)]) as prof:
            res = sim.run(max_rounds=args.rounds, eval_every=1)
        device_ops = prof.profiler.kineto_results.events()
    else:
        res = sim.run(max_rounds=args.rounds, eval_every=1)

    records = _read_jsonl(io.StringIO(sink.getvalue()))
    if args.jsonl_out:
        with open(args.jsonl_out, "w") as fh:
            fh.write(sink.getvalue())
    recorder = getattr(engine, "timer", None)
    doc = timeline(records, recorder, spans, device_ops, device_type)
    write_perfetto(args.out, doc)
    rep = res["telemetry"]
    print(rep.summary())
    n_wall = sum(len(r.spans) for r in (recorder, spans) if r is not None)
    pids = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    n_dev = sum(e["ph"] == "X" and e["pid"] == pids.get("device")
                for e in doc["traceEvents"])
    print(f"wrote {args.out}: {len(doc['traceEvents'])} trace events "
          f"({len(records)} JSONL records + {n_wall} wall spans"
          + (f" + {n_dev} device operations" if args.profile else "")
          + ")")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Perfetto timeline capture/convert for the engines")
    sub = ap.add_subparsers(dest="cmd", required=True)

    cv = sub.add_parser("convert",
                        help="JSONL engine trace -> Perfetto JSON")
    cv.add_argument("trace", help="input JSONL trace path")
    cv.add_argument("--out", required=True, help="output trace JSON path")
    cv.set_defaults(fn=_cmd_convert)

    cp = sub.add_parser(
        "capture",
        help="run a small workload and write its dual-clock timeline")
    cp.add_argument("--out", required=True, help="output trace JSON path")
    cp.add_argument("--engine", default="device",
                    choices=["event", "cohort", "device"])
    cp.add_argument("--scenario", default="mobile_diurnal")
    cp.add_argument("--strategy", default=None,
                    help="aggregation strategy spec (e.g. fedasync)")
    cp.add_argument("--clients", type=int, default=6)
    cp.add_argument("--rounds", type=int, default=3)
    cp.add_argument("--d", type=int, default=2)
    cp.add_argument("--seed", type=int, default=2)
    cp.add_argument("--dp", action="store_true",
                    help="enable the DP clip+noise path")
    cp.add_argument("--jsonl-out", default=None,
                    help="also keep the raw JSONL trace here")
    cp.add_argument("--profile", action="store_true",
                    help="run under torch.profiler and add its device "
                         "operations on the spans' clock")
    cp.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    cp.set_defaults(fn=_cmd_capture)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
