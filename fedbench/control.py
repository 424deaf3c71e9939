"""Readings that set the comparison's limits from above: the reference
put in the program's place, in a lower precision or with a fault
planted, judged by the comparison against the sound reference at the
ticks a run reads (the first ticks and the end of a window of
``window_ticks``).

    python3 fedbench/control.py --workload <name> --seeds 1 2 3 \\
        [--kinds control state half answer]

Kinds: ``control``, the reference in the nearest precision below the
configuration's (the task's ``control_reference``); ``state``, a tick
that returns its state unchanged; ``half``, half of the batch left out
and the mean taken over the rest (the task's ``half_reference``);
``answer``, one finished client's update altered where it is produced
(its sent row negated).  Prints one
JSON line a (seed, kind) with the comparison's numbers, and whether the
limits of the configuration's file catch it.  The benchmark's runs do
not run this; it needs the cell's card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

KINDS = ("control", "state", "half", "answer")


def faulty(bench, kind: str):
    """The reference with fault ``kind`` planted."""
    if kind == "half":
        return bench.half_reference()
    ref = bench.reference()
    if kind == "state":
        ref.step = lambda: setattr(ref, "t", ref.t + 1)
    elif kind == "answer":
        inner = ref.send

        def send(rows):
            sent = inner(rows).clone()
            sent[0] = -sent[0]
            return sent
        ref.send = send
    return ref


def readings(workload: str, seeds, kinds=KINDS, device="cuda",
             overrides=None):
    """Yield a dict a (seed, kind): the comparison's numbers and the
    names of those its limits catch.  ``overrides`` as ``run_cell``'s."""
    import torch
    from fedbench import harness, traffic
    from fedbench.reference import compare as cmp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(workload)
    cfg = {**c["config"], **(overrides or {}).get("config", {})}
    proto = traffic.read({**c["traffic"],
                          **(overrides or {}).get("traffic", {})})
    task = importlib.import_module(f"fedbench.tasks.{cfg['task']}")
    dev = torch.device(device)
    for seed in seeds:
        bench = task.build(cfg, proto, seed, dev)
        bench.release()
        for kind in kinds:
            t0 = time.perf_counter()
            ref = (bench.control_reference() if kind == "control"
                   else faulty(bench, kind))
            # the ticks a run reads: the first ticks and the window's end
            snaps = []
            for _ in range(proto.warm_ticks):
                ref.step()
                snaps.append(bench.cohort_snapshot(ref))
            for _ in range(proto.window_ticks):
                ref.step()
            snaps.append(dict(bench.cohort_snapshot(ref), window_end=True))
            del ref
            numbers = cmp.compare(snaps, bench.reference(), bench.float_gaps)
            yield dict(workload=workload, seed=seed, kind=kind,
                       numbers=numbers,
                       caught=cmp.judge(numbers, cfg["limits"]),
                       seconds=time.perf_counter() - t0)
            del snaps
            if dev.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=KINDS)
    args = ap.parse_args(argv)
    for r in readings(args.workload, args.seeds, args.kinds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
