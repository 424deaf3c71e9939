"""One run of one cell: set-up, the measured window, the traced
per-layer metrics, the check against the plain reference, the result.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json`` names its configuration and traffic; the
configuration's file (``fedbench/configs/<config>.json``) names the task
builder (``fedbench/tasks/<task>.py``) and holds the comparison's
limits; the traffic's file (``fedbench/traffic/<traffic>.json``) holds
the protocol's parameters; each per-layer metric is read by
``fedbench/metrics/<metric>.py``.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from fedbench import probes, traffic
from fedbench.reference import compare as cmp
from fedbench.reference.protocol import OPS

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the server round no call reaches: a call ends on its tick budget alone
NO_TARGET = 1 << 60


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration's and
    traffic's files read, and the metrics it reports."""
    spec = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg_file = load_json(root / cfgs[w["config"]]["file"])
    traf = load_json(root / "fedbench" / "traffic" / f"{w['traffic']}.json")

    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    mine = {m["name"] for m in e2e}
    # a per-layer metric without a list of cells is reported wherever the
    # end-to-end metric it moves is
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in mine)]
    return dict(workload=w, config=cfg_file, traffic=traf, end_to_end=e2e,
                per_layer=per_layer, run_seconds=spec["run_seconds"])


def metric_module(name: str):
    """The reader of per-layer metric ``name``: ``fedbench/metrics/
    <name>.py``, where ``<name>`` drops a ``.suffix`` that splits one
    quantity by the end-to-end metric it moves (``mfu.tokens``)."""
    return importlib.import_module(
        f"fedbench.metrics.{name.split('.')[0]}")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _edge(engine) -> dict:
    """The counters read at a window edge."""
    st = engine.local_state
    return dict(i=st.i.cpu().numpy(), h=st.h.cpu().numpy(),
                ops=st.ops.cpu().numpy().astype(np.int64),
                syncs=sum(engine.host_syncs.values()))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda",
             overrides: Optional[Dict[str, dict]] = None):
    """One run; returns the result line's object and the forbidden
    modules loaded by then.  ``overrides`` replaces keys of the
    configuration's and the traffic's files (the CPU tests' small
    sizes)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = cell(workload)
    cfg = {**c["config"], **(overrides or {}).get("config", {})}
    traf = {**c["traffic"], **(overrides or {}).get("traffic", {})}
    proto = traffic.read(traf)
    dev = torch.device(device)
    task = importlib.import_module(f"fedbench.tasks.{cfg['task']}")

    # ---- set-up: inputs and simulator, then the first ticks, one a call
    marks = [("start", time.perf_counter())]
    from repro_torch import _build
    unbuilt = [n for n in _build.SOURCES if not _build.lib_path(n).exists()]
    bench = task.build(cfg, proto, seed, dev)
    eng = bench.engine
    marks.append(("inputs and simulator", time.perf_counter()))
    snaps, check_s = [], 0.0
    for t in range(1, proto.warm_ticks + 1):
        eng.segment(NO_TARGET, t)
        t0 = time.perf_counter()
        snaps.append(bench.snapshot(eng))
        check_s += time.perf_counter() - t0
    _sync(dev)
    marks.append(("first ticks", time.perf_counter() - check_s))
    setup_s = marks[-1][1] - t_start
    parts = [("imports", marks[0][1] - t_start)] + [
        (name, t - marks[n][1]) for n, (name, t) in enumerate(marks[1:])]
    print("fedbench setup_s " + " ".join(f"{n.replace(' ', '_')}={v:.3f}"
                                         for n, v in parts)
          + f" (check snapshots {check_s:.3f} s, not counted)",
          file=sys.stderr)
    # a run that built CUDA libraries into build/cuda/ is the checkout's
    # first: its set-up is cold
    built = [n for n in unbuilt if _build.lib_path(n).exists()]
    print("fedbench setup: " + (f"cold, built {', '.join(built)}" if built
                                else "warm, every library found built"),
          file=sys.stderr)

    # ---- the window ------------------------------------------------------
    ctx: dict = {}
    undo = []
    mods = {m["name"]: metric_module(m["name"]) for m in c["per_layer"]}
    wanted = {p for m in mods.values() for p in m.PROBES} if trace else set()
    if trace:
        for p in sorted(wanted & set(probes.PROBES)):
            undo.append(probes.PROBES[p](eng, ctx))
        for m in mods.values():
            if hasattr(m, "install"):
                undo.append(m.install(eng, ctx))
    e0 = _edge(eng)
    span = probes.host_range if trace else _no_range
    ticks = proto.window(seconds, c["run_seconds"])
    with probes.profiled("profiler" in wanted, ctx):
        _sync(dev)
        ns0, w0 = time.time_ns(), time.perf_counter()
        with span(ctx, "segment"):
            eng.segment(NO_TARGET, proto.warm_ticks + ticks)
        _sync(dev)
        wall = time.perf_counter() - w0
        ctx["window_ns"] = (ns0, time.time_ns())
    print(f"fedbench window: {ticks} ticks in one call, {wall:.3f} s",
          file=sys.stderr)
    for u in reversed(undo):
        u()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    # the state the window leaves, read for the check
    snaps.append(dict(bench.snapshot(eng), window_end=True))
    e1 = _edge(eng)
    useful = int((proto.steps_done(e1["i"], e1["h"])
                  - proto.steps_done(e0["i"], e0["h"])).sum())
    census = dict(zip(OPS, (e1["ops"] - e0["ops"]).tolist()))
    executed = proto.b_stat * census["block_ticks"] * proto.clients
    metrics = {
        "client_steps_per_s": lambda: useful / wall,
        "train_tokens_per_s": lambda: useful * bench.tokens_per_step / wall,
        "peak_mem_gib": lambda: peak / 2 ** 30,
        "setup_s": lambda: setup_s,
    }
    result = dict(correct=False, attempted=useful, failed=0, metrics={},
                  device=_device(dev, peak), setup_cold=bool(built))
    if trace:
        from fedbench.trace import DeviceTrace
        ctx.update(census=census, host_syncs=e1["syncs"] - e0["syncs"],
                   wall_s=wall, useful_steps=useful, executed_steps=executed,
                   flops_per_step=bench.flops_per_step,
                   state=tuple(eng.local_state))
        if "trace_events" in ctx:
            ctx["trace"] = DeviceTrace(ctx.pop("trace_events"),
                                       ctx["window_ns"],
                                       ctx.get("host_ranges", ()))
            tr = ctx["trace"]
            if tr.ops:
                print(f"fedbench trace: {len(tr.ops)} device operations, "
                      f"the first {(tr.ops[0][0] - tr.t0) / 1e6:.3f} ms "
                      f"after the window opened, the last ending "
                      f"{(tr.t1 - tr.ops[-1][1]) / 1e6:.3f} ms before it "
                      f"closed", file=sys.stderr)
        if ctx.get("launches"):
            ctx["launches_host"] = _host_args(ctx["launches"])
        for m in c["per_layer"]:
            v = mods[m["name"]].read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        tr = ctx.get("trace")
        if tr is not None:
            result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = {"device_ops": tr.top_ops(),
                                   "idle_gaps": tr.longest_gaps()}
    else:
        for m in c["end_to_end"]:
            result["metrics"][m["name"]] = {
                "value": float(metrics[m["name"]]()), "unit": m["unit"]}
    ctx.clear()
    found = forbidden_modules()

    # ---- the check: the program released, the reference from the inputs
    bench.release()
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cmp.compare(snaps, bench.reference(), bench.float_gaps)
    print(f"fedbench reference check {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    limits = cfg["limits"]
    bad = cmp.judge(numbers, limits)
    result["correct"] = not bad
    result["failed"] = 0 if not bad else 1
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in numbers.items()}
    return result, found


@contextlib.contextmanager
def _no_range(ctx, label):
    yield


def _host_args(launches):
    """The launches' device scalars read in one copy."""
    import torch
    flat, where = [], []
    for n, (_, a) in enumerate(launches):
        for k, v in a.items():
            if torch.is_tensor(v):
                where.append((n, k))
                flat.append(v.reshape(()).to(torch.int64))
    vals = torch.stack(flat).tolist() if flat else []
    out = [(k, dict(a)) for k, a in launches]
    for (n, k), v in zip(where, vals):
        out[n][1][k] = v
    return out


def _device(dev, peak: int) -> dict:
    import torch
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                count=1, memory_peak_bytes=int(peak))
