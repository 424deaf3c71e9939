"""Span recording + Chrome/Perfetto trace-event export, on dual clocks.

``SpanRecorder`` accumulates named wall-clock phases for
``MetricsReport.wall`` (seconds and re-entry counts) and keeps every
individual span — (name, track, start, duration) — so a run can be
rendered as a timeline instead of a histogram.  Host clock only: device
work is asynchronous, so an engine closes a phase only after the work it
times has finished (the engine's host reads do that).

Export targets the Chrome trace-event JSON the Perfetto UI loads
(https://ui.perfetto.dev, legacy JSON importer): complete ``"X"`` slices
for engine phases and eval segments, instant ``"i"`` + flow ``"s"``/
``"f"`` + async ``"b"``/``"e"`` events for message lifecycles.  Two
clocks coexist as two trace *processes*:

  * **wall** — real seconds from the recorder's epoch (first_segment/
    steady/eval engine phases, optionally bracketed with
    ``torch.profiler.record_function`` so the same names show up inside
    a ``torch.profiler`` trace);
  * **virtual protocol seconds** — reconstructed from the JSONL trace
    (``repro_torch.telemetry.trace``): the event sim's per-message
    records become send→apply / broadcast→deliver flow arrows, the
    cohort engines' per-eval ``segment`` records become slices carrying
    the census + op-census counters.

Both clocks are microseconds in the file (the trace-event unit), so a
device-engine run and the event simulator render on one comparable
timeline.  Values reach the file as plain JSON numbers: tensors (0-d
ones too) and numpy scalars in records or span args are converted.
``python -m repro_torch.telemetry`` is the one-invocation CLI that
captures or converts a trace into a Perfetto-loadable file.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import (Any, Dict, IO, Iterable, List, Optional, Sequence,
                    Union)

import torch

from repro_torch.telemetry.trace import _coerce

__all__ = [
    "SpanRecorder", "PhaseTimer", "trace_to_perfetto",
    "validate_trace_events", "write_perfetto",
]


class SpanRecorder:
    """Accumulating phase timer that also keeps the span timeline.

    ``phases``/``counts``/``as_dict`` build every engine's
    ``MetricsReport.wall``; ``spans`` holds one entry per ``phase()``/
    ``add()`` with start times relative to the recorder's epoch (the
    first recorded instant), and ``to_trace_events`` renders them as
    Perfetto slices — one thread track per phase name, so re-entrant
    phases stay non-overlapping per track (invariant INV-SPAN).  With
    ``annotate`` each ``phase()`` is also a
    ``torch.profiler.record_function`` range of the same name.
    """

    def __init__(self, *, annotate: bool = False):
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # (name, track, t0_s, dur_s, args) — t0 relative to epoch
        self.spans: List[Dict[str, Any]] = []
        self.epoch: Optional[float] = None
        self._annotate = bool(annotate)

    # -- recording --------------------------------------------------------
    def _now(self) -> float:
        t = time.perf_counter()
        if self.epoch is None:
            self.epoch = t
        return t - self.epoch

    @contextmanager
    def phase(self, name: str, *, track: Optional[str] = None,
              **args: Any):
        t0 = self._now()
        ann = None
        if self._annotate:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        try:
            yield
        finally:
            if ann is not None:
                ann.__exit__(None, None, None)
            self._record(name, track, t0, self._now() - t0, args)

    span = phase

    def add(self, name: str, seconds: float, *,
            track: Optional[str] = None, **args: Any) -> None:
        """Record a stretch that just ended (duration known, end = now)."""
        dur = float(seconds)
        t0 = self._now() - dur
        self._record(name, track, max(t0, 0.0), dur, args)

    def _record(self, name: str, track: Optional[str], t0: float,
                dur: float, args: Dict[str, Any]) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + dur
        self.counts[name] = self.counts.get(name, 0) + 1
        self.spans.append(dict(name=name, track=track or name, t0=t0,
                               dur=dur, args=dict(args)))

    # -- aggregates (MetricsReport.wall) ----------------------------------
    def as_dict(self, suffix: str = "_s") -> Dict[str, float]:
        """Accumulated seconds per phase (``<name>_s``) AND how many
        spans fed each accumulation (``<name>_n``)."""
        out: Dict[str, float] = {
            f"{k}{suffix}": v for k, v in self.phases.items()}
        out.update({f"{k}_n": n for k, n in self.counts.items()})
        return out

    # -- timeline export --------------------------------------------------
    def to_trace_events(self, builder: Optional["_EventBuilder"] = None,
                        *, process: str = "wall") -> List[Dict[str, Any]]:
        """Render the recorded spans as Perfetto ``"X"`` slices."""
        b = builder or _EventBuilder()
        for s in self.spans:
            b.slice(process, s["track"], s["name"],
                    ts_us=s["t0"] * 1e6, dur_us=s["dur"] * 1e6,
                    args=s["args"])
        return b.events


class PhaseTimer(SpanRecorder):
    """Backwards-compatible name: a SpanRecorder."""


class _EventBuilder:
    """Trace-event assembly: integer pid/tid allocation + ``M`` metadata
    naming them, the way the Perfetto JSON importer expects."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._pids: Dict[str, int] = {}
        self._tids: Dict[tuple, int] = {}

    def pid(self, process: str) -> int:
        p = self._pids.get(process)
        if p is None:
            p = self._pids[process] = len(self._pids) + 1
            self.events.append(dict(
                ph="M", name="process_name", pid=p, tid=0, ts=0,
                args={"name": process}))
        return p

    def tid(self, process: str, thread: str) -> tuple:
        p = self.pid(process)
        key = (p, thread)
        t = self._tids.get(key)
        if t is None:
            t = self._tids[key] = len(self._tids) + 1
            self.events.append(dict(
                ph="M", name="thread_name", pid=p, tid=t, ts=0,
                args={"name": thread}))
        return p, t

    def slice(self, process: str, thread: str, name: str, *,
              ts_us: float, dur_us: float,
              args: Optional[Dict[str, Any]] = None) -> None:
        p, t = self.tid(process, thread)
        self.events.append(dict(
            ph="X", name=name, pid=p, tid=t, ts=float(ts_us),
            dur=max(float(dur_us), 0.0), args=_coerce(args or {})))

    def instant(self, process: str, thread: str, name: str, *,
                ts_us: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        p, t = self.tid(process, thread)
        self.events.append(dict(
            ph="i", s="t", name=name, pid=p, tid=t, ts=float(ts_us),
            args=_coerce(args or {})))

    def flow(self, process: str, thread: str, name: str, flow_id: str,
             *, ts_us: float, start: bool) -> None:
        p, t = self.tid(process, thread)
        self.events.append(dict(
            ph="s" if start else "f", bp="e", cat="flow", name=name,
            id=flow_id, pid=p, tid=t, ts=float(ts_us)))

    def async_span(self, process: str, thread: str, name: str,
                   span_id: str, *, ts_us: float, begin: bool,
                   args: Optional[Dict[str, Any]] = None) -> None:
        p, t = self.tid(process, thread)
        self.events.append(dict(
            ph="b" if begin else "e", cat="lifecycle", name=name,
            id=span_id, pid=p, tid=t, ts=float(ts_us),
            args=_coerce(args or {})))


def trace_to_perfetto(records: Iterable[Dict[str, Any]],
                      builder: Optional[_EventBuilder] = None
                      ) -> List[Dict[str, Any]]:
    """JSONL trace records (``repro_torch.telemetry.trace``) -> trace events.

    Virtual protocol seconds become microseconds.  Event-sim message
    records render as per-client instants with send→apply and
    fire→deliver flow arrows plus an async ``in flight`` span per
    update; cohort ``segment`` records render as consecutive slices on
    the engine's track carrying the census + op-census counters.
    """
    b = builder or _EventBuilder()
    recs = [_coerce(r) for r in records]
    proc = "protocol (virtual)"
    # broadcast fire times, so each delivery's flow can start at the fire
    fired_at = {r["k"]: r["time"] for r in recs
                if r.get("kind") == "broadcast_fired"}
    last_seg_time: Dict[str, float] = {}
    for r in recs:
        kind = r.get("kind")
        if kind == "update_sent":
            us = r["time"] * 1e6
            c, rd = r["client"], r["round"]
            uid = f"u{c}.{rd}"
            ctrack = f"client {c}"
            b.instant(proc, ctrack, "update_sent", ts_us=us,
                      args={k: r[k] for k in ("round", "k_send", "bytes",
                                              "latency_s") if k in r})
            b.async_span(proc, ctrack, "update in flight", uid,
                         ts_us=us, begin=True,
                         args={"round": rd, "client": c})
            b.flow(proc, ctrack, "update", uid, ts_us=us, start=True)
        elif kind == "update_applied":
            us = r["time"] * 1e6
            c, rd = r["client"], r["round"]
            uid = f"u{c}.{rd}"
            b.instant(proc, "server", "update_applied", ts_us=us,
                      args={k: r[k] for k in ("client", "round",
                                              "server_k", "staleness")
                            if k in r})
            b.flow(proc, "server", "update", uid, ts_us=us, start=False)
            b.async_span(proc, f"client {c}", "update in flight", uid,
                         ts_us=us, begin=False)
        elif kind == "broadcast_fired":
            us = r["time"] * 1e6
            b.instant(proc, "server", "broadcast_fired", ts_us=us,
                      args={k: r[k] for k in ("k", "bytes_per_client",
                                              "clients") if k in r})
        elif kind == "broadcast_applied":
            us = r["time"] * 1e6
            c, k = r["client"], r["k"]
            bid = f"b{k}.c{c}"
            b.instant(proc, f"client {c}", "broadcast_applied",
                      ts_us=us, args={kk: r[kk] for kk in ("k", "accepted")
                                      if kk in r})
            if k in fired_at:
                b.flow(proc, "server", "broadcast", bid,
                       ts_us=fired_at[k] * 1e6, start=True)
                b.flow(proc, f"client {c}", "broadcast", bid,
                       ts_us=us, start=False)
        elif kind == "segment":
            eng = r.get("engine", "cohort")
            track = f"{eng} segments"
            t1 = r.get("time")
            if t1 is None:      # older traces carry only the tick
                t1 = float(r.get("tick", 0))
            t0 = last_seg_time.get(track, 0.0)
            last_seg_time[track] = t1
            args = {k: v for k, v in r.items() if k != "kind"}
            b.slice(proc, track, f"segment→round {r.get('round')}",
                    ts_us=t0 * 1e6, dur_us=(t1 - t0) * 1e6, args=args)
        elif kind == "report":
            # terminal summary as a zero-duration instant on the engine
            # track, args carrying the whole MetricsReport
            eng = r.get("engine", "engine")
            t1 = r.get("virtual_time") or last_seg_time.get(
                f"{eng} segments", 0.0)
            b.instant(proc, f"{eng} segments", "report",
                      ts_us=float(t1 or 0.0) * 1e6,
                      args={k: v for k, v in r.items() if k != "kind"})
    return b.events


def merge_trace_events(*event_lists: Sequence[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Wrap one or more event lists as a loadable trace-event document."""
    events: List[Dict[str, Any]] = []
    for lst in event_lists:
        events.extend(lst)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(path_or_fh: Union[str, IO[str]],
                   events_or_doc: Union[Sequence[Dict[str, Any]],
                                        Dict[str, Any]]) -> None:
    """Write a trace-event document Perfetto's JSON importer loads."""
    doc = _coerce(events_or_doc if isinstance(events_or_doc, dict)
                  else merge_trace_events(events_or_doc))
    problems = validate_trace_events(doc)
    if problems:
        raise ValueError("refusing to write invalid trace: "
                         + "; ".join(problems[:5]))
    if isinstance(path_or_fh, (str, bytes)):
        with open(path_or_fh, "w") as fh:
            json.dump(doc, fh)
    else:
        json.dump(doc, path_or_fh)


# phase types and the keys each requires beyond (ph, name, pid, tid, ts)
_PH_REQUIRED = {
    "X": ("dur",), "M": ("args",), "i": (), "s": ("id",), "t": ("id",),
    "f": ("id",), "b": ("id",), "e": ("id",),
}
# float-µs comparisons: one nanosecond of slack
_OVERLAP_EPS_US = 1e-3


def validate_trace_events(doc: Any, *, check_overlap: bool = True
                          ) -> List[str]:
    """Schema + invariant check of a trace-event document.

    Returns human-readable problems (empty = valid): the document shape,
    per-``ph`` required keys, numeric non-negative timestamps, and —
    the INV-SPAN track discipline — complete ``"X"`` slices
    non-overlapping per (pid, tid) track.
    """
    problems: List[str] = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return ["document must be an object with a traceEvents list"]
    slices: Dict[tuple, List[tuple]] = {}
    for n, ev in enumerate(doc["traceEvents"]):
        where = f"traceEvents[{n}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        for key in ("name", "pid", "tid", "ts") + _PH_REQUIRED[ph]:
            if key not in ev:
                problems.append(f"{where}: ph={ph} missing {key!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts must be a non-negative number,"
                            f" got {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X slice dur must be a "
                                f"non-negative number, got {dur!r}")
                continue
            slices.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ts), float(dur), ev.get("name"), n))
    if check_overlap:
        for (pid, tid), rows in slices.items():
            rows.sort()
            for (t0, d0, n0, i0), (t1, d1, n1, i1) in zip(rows, rows[1:]):
                if t1 < t0 + d0 - _OVERLAP_EPS_US:
                    problems.append(
                        f"track (pid={pid}, tid={tid}): slice {n1!r} "
                        f"(traceEvents[{i1}], ts={t1}) overlaps "
                        f"{n0!r} (traceEvents[{i0}], "
                        f"ts={t0} dur={d0}) — spans must be "
                        f"non-overlapping per track")
    return problems
