"""Span recording: accumulating wall-clock phases with their timeline.

``SpanRecorder`` accumulates named wall-clock phases for
``MetricsReport.wall`` (seconds and re-entry counts) and keeps every
individual span — (name, track, start, duration) — so a run can be
rendered as a timeline.  Host clock only: device work is asynchronous,
so an engine closes a phase only after the work it times has finished
(the engine's host reads do that).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class SpanRecorder:
    """Accumulating phase timer that also keeps the span timeline."""

    def __init__(self):
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # (name, track, t0_s, dur_s, args) — t0 relative to epoch
        self.spans: List[Dict[str, Any]] = []
        self.epoch: Optional[float] = None

    def _now(self) -> float:
        t = time.perf_counter()
        if self.epoch is None:
            self.epoch = t
        return t - self.epoch

    @contextmanager
    def phase(self, name: str, *, track: Optional[str] = None,
              **args: Any):
        t0 = self._now()
        try:
            yield
        finally:
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

    def as_dict(self, suffix: str = "_s") -> Dict[str, float]:
        """Accumulated seconds per phase (``<name>_s``) AND how many
        spans fed each accumulation (``<name>_n``)."""
        out: Dict[str, float] = {
            f"{k}{suffix}": v for k, v in self.phases.items()}
        out.update({f"{k}_n": n for k, n in self.counts.items()})
        return out


class PhaseTimer(SpanRecorder):
    """Backwards-compatible name: a SpanRecorder."""
