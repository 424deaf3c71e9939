"""The program's own spans over the traced window, and the device's idle
time split by what the host was doing.

``install(engine, ctx)`` sets one ``repro_torch.telemetry.SpanRecorder``
as the device cohort engine's ``spans`` for the window: each metric
module that reads it installs it, the first sets it and the last undo
takes it off the engine (the recorder stays in ``ctx`` for the readers).
An engine without ``spans`` is left as it is, and the readers then find
nothing to read.

The engine's spans carry ``time.time_ns()`` edges, the clock of the
profiler's device events, so each nanosecond of each idle gap of the
device trace is put under the innermost program span open on the host
over it (by overlap, not by a gap's midpoint):

* ``client_block``: under ``client_block`` or a child of it;
* ``noise``: under ``clip_noise`` or a child of it;
* ``tick_host``: inside ``segment`` and in neither of those (the integer
  phase, the tick's read, the server step, deliver, the ring scatter and
  between ticks);
* ``outside``: under no program span (the window's edges).

The four add up to the device's idle time over the window.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

KEY = "program_spans"
_USERS = "program_spans.users"
_SPLIT = "program_spans.idle"
#: the idle time's parts, by the span that opens each
PARTS = {"client_block": "client_block", "clip_noise": "noise"}


def install(engine, ctx):
    """Set the shared recorder on ``engine`` (once per window); returns
    the undo."""
    if not hasattr(engine, "spans"):
        return lambda: None
    if KEY not in ctx:
        from repro_torch.telemetry import SpanRecorder
        ctx[KEY] = SpanRecorder(device=engine.device)
        ctx[_USERS] = 0
        engine.spans = ctx[KEY]
    ctx[_USERS] += 1

    def undo():
        ctx[_USERS] -= 1
        if ctx[_USERS] == 0:
            engine.spans = None
    return undo


def recorder(ctx):
    """The window's recorder with its device times resolved (the harness
    has synchronized), or None where the program records no spans."""
    rec = ctx.get(KEY)
    if rec is None or not rec.spans:
        return None
    rec.resolve()
    return rec


def spans_named(ctx, name: str) -> List[dict]:
    rec = recorder(ctx)
    return [] if rec is None else [s for s in rec.spans if s["name"] == name]


def _paths(spans) -> Dict[int, Tuple[str, ...]]:
    """Each span's names from its root down to itself, by ``id``."""
    by_id = {s["id"]: s for s in spans}
    out: Dict[int, Tuple[str, ...]] = {}

    def path(s):
        if s["id"] not in out:
            p = by_id.get(s["parent"])
            out[s["id"]] = (path(p) if p is not None else ()) + (s["name"],)
        return out[s["id"]]
    for s in spans:
        path(s)
    return out


def pieces(spans) -> List[Tuple[int, int, dict]]:
    """The host's timeline as (start_ns, end_ns, span) pieces in order,
    each under the innermost span open over it."""
    by_id = {s["id"] for s in spans}
    kids, roots = defaultdict(list), []
    for s in spans:
        (kids[s["parent"]] if s["parent"] in by_id else roots).append(s)
    out: List[Tuple[int, int, dict]] = []

    def walk(s, a: int, b: int) -> None:
        cur = a
        for k in sorted(kids[s["id"]], key=lambda x: x["start_ns"]):
            ka, kb = max(k["start_ns"], cur), min(k["end_ns"], b)
            if ka > cur:
                out.append((cur, ka, s))
            if kb > ka:
                walk(k, ka, kb)
                cur = kb
        if b > cur:
            out.append((cur, b, s))
    cur = None
    for r in sorted(roots, key=lambda x: x["start_ns"]):
        a = r["start_ns"] if cur is None else max(r["start_ns"], cur)
        if r["end_ns"] > a:
            walk(r, a, r["end_ns"])
            cur = r["end_ns"]
    return out


def part_of(path: Tuple[str, ...]) -> str:
    """The idle part a span's path falls under."""
    for name in path:
        if name in PARTS:
            return PARTS[name]
    return "tick_host" if "segment" in path else "outside"


def attribute(gaps, spans) -> Tuple[Dict[str, int], List[dict]]:
    """Idle nanoseconds by part, and for each gap its nanoseconds by the
    innermost span (``by_span``: span ``id`` -> ns, None for no span)."""
    paths = _paths(spans)
    ps = pieces(spans)
    totals = dict.fromkeys(("client_block", "noise", "tick_host", "outside"),
                           0)
    per_gap = []
    j = 0
    for a, b in gaps:
        while j < len(ps) and ps[j][1] <= a:
            j += 1
        by: Dict[Optional[int], int] = defaultdict(int)
        k = j
        while k < len(ps) and ps[k][0] < b:
            ov = min(b, ps[k][1]) - max(a, ps[k][0])
            if ov > 0:
                by[ps[k][2]["id"]] += ov
            k += 1
        rest = b - a - sum(by.values())
        if rest > 0:
            by[None] += rest
        for sid, ns in by.items():
            totals["outside" if sid is None else part_of(paths[sid])] += ns
        per_gap.append(dict(start_ns=a, end_ns=b, by_span=dict(by)))
    return totals, per_gap


def idle_split(ctx) -> Optional[Dict[str, int]]:
    """The window's idle nanoseconds by part, computed once; the split
    and the ten longest gaps, each with the span path it fell under, the
    allocator's counters of that span or its nearest ancestor that has
    them and the device operation that ended it, go to standard
    error."""
    if _SPLIT in ctx:
        return ctx[_SPLIT]
    tr, rec = ctx.get("trace"), recorder(ctx)
    split = None
    if tr is not None and tr.ops and rec is not None:
        split, per_gap = attribute(tr.gaps(), rec.spans)
        _report(split, per_gap, rec.spans, tr)
    ctx[_SPLIT] = split
    return split


def _report(split, per_gap, spans, tr) -> None:
    from fedbench.trace import _short
    window_ns = tr.t1 - tr.t0
    starts = [a for a, _, _ in tr.ops]
    print("fedbench program spans: idle by part, % of the window: "
          + ", ".join(f"{k} {100.0 * v / window_ns:.5f}"
                      for k, v in split.items()), file=sys.stderr)
    paths = _paths(spans)
    by_id = {s["id"]: s for s in spans}
    for g in sorted(per_gap, key=lambda g: g["start_ns"] - g["end_ns"])[:10]:
        ns = g["end_ns"] - g["start_ns"]
        sid, most = max(g["by_span"].items(), key=lambda kv: kv[1])
        if sid is None:
            where = "outside every span"
        else:
            s = by_id[sid]
            where = f"{'/'.join(paths[sid])} (t {s['t']})"
            while s is not None and not s["counters"]:
                s = by_id.get(s["parent"])
            if s is not None:
                where += f", {s['name']}: " + ", ".join(
                    f"{k} {v}" for k, v in s["counters"].items())
        n = bisect.bisect_left(starts, g["end_ns"])
        after = _short(tr.ops[n][2])[:100] if n < len(starts) else "none"
        print(f"fedbench program spans: gap {ns / 1e9:.6f} s, "
              f"{100.0 * most / ns:.1f}% under {where}; next device "
              f"operation {after}", file=sys.stderr)
