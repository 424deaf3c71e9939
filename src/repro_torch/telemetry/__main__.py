"""``python -m repro_torch.telemetry`` — one-invocation Perfetto timelines.

Two modes:

  * ``capture``: run a small engine workload end-to-end and write a
    Perfetto-loadable trace JSON combining BOTH clocks — the engine's
    wall-clock phase spans (first_segment/steady/eval, from
    ``SpanRecorder``) and the virtual-protocol timeline reconstructed
    from the run's JSONL trace (message lifecycles / eval segments with
    op-census counters).  It runs on the card; ``--device cpu`` runs the
    plain PyTorch versions of the kernels instead.

      PYTHONPATH=src python -m repro_torch.telemetry capture --out trace.json

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

from repro_torch.telemetry.spans import (_EventBuilder, merge_trace_events,
                                         trace_to_perfetto, write_perfetto)


def _read_jsonl(fh) -> List[dict]:
    return [json.loads(line) for line in fh if line.strip()]


def timeline(records: List[dict], recorder=None) -> dict:
    """One trace-event document from a run's JSONL records and, when
    given, its ``SpanRecorder``: ONE builder, so the virtual and wall
    processes get distinct pids."""
    builder = _EventBuilder()
    trace_to_perfetto(records, builder)
    if recorder is not None:
        recorder.to_trace_events(builder, process="wall")
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
    res = sim.run(max_rounds=args.rounds, eval_every=1)

    records = _read_jsonl(io.StringIO(sink.getvalue()))
    if args.jsonl_out:
        with open(args.jsonl_out, "w") as fh:
            fh.write(sink.getvalue())
    recorder = getattr(getattr(sim, "engine", sim), "timer", None)
    doc = timeline(records, recorder)
    write_perfetto(args.out, doc)
    rep = res["telemetry"]
    print(rep.summary())
    print(f"wrote {args.out}: {len(doc['traceEvents'])} trace events "
          f"({len(records)} JSONL records + "
          f"{len(recorder.spans) if recorder else 0} wall spans)")
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
    cp.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    cp.set_defaults(fn=_cmd_capture)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
