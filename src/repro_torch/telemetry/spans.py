"""Span recording + Chrome/Perfetto trace-event export, on dual clocks.

``SpanRecorder`` accumulates named wall-clock phases for
``MetricsReport.wall`` (seconds and re-entry counts) and keeps every
individual span — (name, track, start, duration, parent, tick) — so a
run can be rendered as a timeline instead of a histogram.  A span times
the host: device work is asynchronous, so a span over a launch ends when
the launch is enqueued.  Its absolute edges are on ``time.time_ns()``,
the clock of ``torch.profiler``'s events, so the host spans and the
device trace of one run line up (``device_events``); a span opened with
``device=True`` also times its device work with two CUDA events, and one
opened with ``alloc=True`` counts the caching allocator's device
allocations, frees, retries and syncs over it.  The device cohort engine
records its tick's spans into ``engine.spans`` when one is set.

Export targets the Chrome trace-event JSON the Perfetto UI loads
(https://ui.perfetto.dev, legacy JSON importer): complete ``"X"`` slices
for engine phases and eval segments, instant ``"i"`` + flow ``"s"``/
``"f"`` + async ``"b"``/``"e"`` events for message lifecycles.  Two
clocks coexist as two trace *processes*:

  * **wall** — real seconds from the recorder's epoch, or from a
    shared ``time.time_ns()`` origin (first_segment/steady/eval engine
    phases, the device engine's tick spans, optionally bracketed with
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
from contextlib import contextmanager, nullcontext
from typing import (Any, Dict, IO, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.telemetry.trace import _coerce

__all__ = [
    "SpanRecorder", "device_events", "maybe_span", "trace_to_perfetto",
    "validate_trace_events", "write_perfetto",
]


class SpanRecorder:
    """Accumulating phase timer that also keeps the span timeline.

    ``phases``/``counts``/``as_dict`` build every engine's
    ``MetricsReport.wall``; ``spans`` holds one entry per ``phase()``/
    ``add()``, appended as it closes, with

    * ``t0``/``dur``: seconds from the recorder's epoch (the first
      recorded instant, ``time.perf_counter``);
    * ``start_ns``/``end_ns``: ``time.time_ns()``, the clock of
      ``torch.profiler``'s (kineto's) events, so a span can be laid
      beside a device trace;
    * ``id`` (in opening order), ``parent`` (the ``id`` of the span open
      when it began, or None) and ``t`` (the tick it belongs to: its own
      ``t=`` argument, else its parent's), so the spans of one engine
      tick share an identifier;
    * ``counters``: what ``count()`` added while it was the innermost
      open span, and the allocator's deltas over it (``alloc=True``);
    * ``device_s``: with ``device=True`` and a CUDA recorder, the device
      time between two CUDA events recorded on the current stream at
      its edges (no sync; filled in by ``resolve()``).

    ``to_trace_events`` renders the spans as Perfetto slices — one
    thread track per phase name, so re-entrant phases stay
    non-overlapping per track (invariant INV-SPAN).  With ``annotate``
    each ``phase()`` is also a ``torch.profiler.record_function`` range
    of the same name.  ``device`` is where the recorded work runs: the
    CUDA events and allocator counters are taken only on a CUDA device
    and are no-ops elsewhere.  ``launches`` holds the (kernel, arguments)
    of each launch the program records there, device scalars left on the
    device.
    """

    #: ``torch.cuda.memory_stats`` counters recorded by ``alloc=True``
    ALLOC_STATS = ("num_device_alloc", "num_device_free",
                   "num_alloc_retries", "num_sync_all_streams")

    def __init__(self, *, annotate: bool = False, device=None):
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[Dict[str, Any]] = []
        self.epoch: Optional[float] = None
        self.launches: List[Tuple[str, Dict[str, Any]]] = []
        self._annotate = bool(annotate)
        self.device = torch.device(device) if device is not None else None
        self._cuda = self.device is not None and self.device.type == "cuda"
        # the open spans, innermost last: [id, t, counters]
        self._open: List[list] = []
        self._next_id = 0
        # spans whose CUDA events wait for resolve()
        self._pending: List[tuple] = []

    # -- recording --------------------------------------------------------
    def _now(self) -> float:
        t = time.perf_counter()
        if self.epoch is None:
            self.epoch = t
        return t - self.epoch

    def _alloc_stats(self) -> List[int]:
        st = torch.cuda.memory_stats(self.device)
        return [int(st.get(k, 0)) for k in self.ALLOC_STATS]

    @contextmanager
    def phase(self, name: str, *, track: Optional[str] = None,
              device: bool = False, alloc: bool = False, **args: Any):
        parent = self._open[-1] if self._open else None
        t = args.get("t", parent[1] if parent else None)
        frame = [self._next_id, t, {}]
        self._next_id += 1
        self._open.append(frame)
        events = alloc0 = None
        if self._cuda:
            if alloc:
                alloc0 = self._alloc_stats()
            if device:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
        ann = None
        if self._annotate:
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        ns0, t0 = time.time_ns(), self._now()
        try:
            yield
        finally:
            t1, ns1 = self._now(), time.time_ns()
            if ann is not None:
                ann.__exit__(None, None, None)
            if events is not None:
                events[1].record()
            if alloc0 is not None:
                for k, a, b in zip(self.ALLOC_STATS, alloc0,
                                   self._alloc_stats()):
                    frame[2][k] = frame[2].get(k, 0) + b - a
            self._open.pop()
            span = self._record(name, track, t0, t1 - t0, args,
                                start_ns=ns0, end_ns=ns1, id=frame[0],
                                parent=parent[0] if parent else None, t=t,
                                counters=frame[2])
            if events is not None:
                self._pending.append((span, events))

    span = phase

    def add(self, name: str, seconds: float, *,
            track: Optional[str] = None, **args: Any) -> None:
        """Record a stretch that just ended (duration known, end = now)."""
        dur = float(seconds)
        t0 = self._now() - dur
        ns1 = time.time_ns()
        parent = self._open[-1] if self._open else None
        self._record(name, track, max(t0, 0.0), dur, args,
                     start_ns=ns1 - int(dur * 1e9), end_ns=ns1,
                     id=self._next_id, parent=parent[0] if parent else None,
                     t=args.get("t", parent[1] if parent else None),
                     counters={})
        self._next_id += 1

    def _record(self, name: str, track: Optional[str], t0: float,
                dur: float, args: Dict[str, Any], **more: Any
                ) -> Dict[str, Any]:
        self.phases[name] = self.phases.get(name, 0.0) + dur
        self.counts[name] = self.counts.get(name, 0) + 1
        span = dict(name=name, track=track or name, t0=t0, dur=dur,
                    args=dict(args), **more)
        self.spans.append(span)
        return span

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span (none
        open: nothing is counted)."""
        if self._open:
            c = self._open[-1][2]
            c[name] = c.get(name, 0) + n

    def resolve(self) -> None:
        """Each ``device=True`` span's ``device_s`` from its CUDA events;
        call after the device has finished the recorded work."""
        for span, (e0, e1) in self._pending:
            span["device_s"] = e0.elapsed_time(e1) / 1e3
        self._pending = []

    # -- aggregates -------------------------------------------------------
    def as_dict(self, suffix: str = "_s") -> Dict[str, float]:
        """Accumulated seconds per phase (``<name>_s``) AND how many
        spans fed each accumulation (``<name>_n``)."""
        out: Dict[str, float] = {
            f"{k}{suffix}": v for k, v in self.phases.items()}
        out.update({f"{k}_n": n for k, n in self.counts.items()})
        return out

    def self_seconds(self) -> Dict[int, float]:
        """Each span's self time by ``id``: its duration less its
        children's."""
        out = {s["id"]: s["dur"] for s in self.spans}
        for s in self.spans:
            if s.get("parent") in out:
                out[s["parent"]] -= s["dur"]
        return out

    # -- timeline export --------------------------------------------------
    def to_trace_events(self, builder: Optional["_EventBuilder"] = None,
                        *, process: str = "wall",
                        origin_ns: Optional[int] = None
                        ) -> List[Dict[str, Any]]:
        """Render the recorded spans as Perfetto ``"X"`` slices, each with
        its parent's name (``parent``) and its tick (``t``) among its args
        where it has them.  Times are from the recorder's epoch, or with
        ``origin_ns`` from that instant of ``time.time_ns()`` (the clock
        shared with other recorders and with ``torch.profiler``'s
        events)."""
        b = builder or _EventBuilder()
        names = {s.get("id"): s["name"] for s in self.spans}
        for s in self.spans:
            args = dict(s["args"])
            if s.get("parent") is not None:
                args["parent"] = names[s["parent"]]
            if s.get("t") is not None:
                args["t"] = s["t"]
            if origin_ns is None:
                ts, dur = s["t0"] * 1e6, s["dur"] * 1e6
            else:
                ts = (s["start_ns"] - origin_ns) / 1e3
                dur = (s["end_ns"] - s["start_ns"]) / 1e3
            b.slice(process, s["track"], s["name"], ts_us=ts, dur_us=dur,
                    args=args)
        return b.events


_OFF = nullcontext()


def maybe_span(rec: Optional[SpanRecorder], name: str, **kw: Any):
    """``rec.phase(name, **kw)``, or one shared no-op context where
    ``rec`` is None: a recorder left off makes no span, no CUDA event
    and no allocator read."""
    return _OFF if rec is None else rec.phase(name, **kw)


def _device_type(e) -> str:
    return str(e.device_type()).split(".")[-1].upper()


def device_events(events, builder: Optional["_EventBuilder"] = None, *,
                  origin_ns: int, device_type: str = "CUDA",
                  process: str = "device") -> List[Dict[str, Any]]:
    """``torch.profiler``'s kineto events (``prof.profiler.kineto_results
    .events()``) of ``device_type`` as ``"X"`` slices of ``process``,
    times from ``origin_ns`` of ``time.time_ns()`` (the kineto clock, so
    they sit under a recorder's spans rendered from the same origin).
    One track per device and stream (per thread for ``"CPU"``); an
    operation that overlaps the one before it on its track (nested host
    operations) goes to the next free lane of that track."""
    b = builder or _EventBuilder()
    lanes: Dict[str, List[int]] = {}
    what = "stream" if device_type == "CUDA" else "thread"
    ops = sorted((e.start_ns(), e.end_ns(), e.name(),
                  f"{device_type.lower()} {e.device_index()} {what} "
                  f"{e.device_resource_id()}")
                 for e in events if _device_type(e) == device_type
                 and e.duration_ns() > 0 and e.start_ns() >= origin_ns)
    for a, z, name, track in ops:
        ends = lanes.setdefault(track, [])
        lane = next((n for n, end in enumerate(ends) if end <= a),
                    len(ends))
        if lane == len(ends):
            ends.append(z)
        ends[lane] = z
        b.slice(process, track if lane == 0 else f"{track} ({lane})", name,
                ts_us=(a - origin_ns) / 1e3, dur_us=(z - a) / 1e3)
    return b.events


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
