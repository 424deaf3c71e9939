"""Reductions of the traced window's device trace (``torch.profiler``'s
kineto events, kept in memory): device operations with their intervals,
the window's bounds, device busy time, idle gaps named by the harness's
host ranges, and time by operation name.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from fedbench.probes import RANGES


def _device_type(e) -> str:
    return str(e.device_type()).split(".")[-1].upper()


def _short(name: str) -> str:
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return name.split("(")[0][:120]


class DeviceTrace:
    """The device operations and host ranges of one traced window."""

    def __init__(self, events, window_ns: Tuple[int, int],
                 host_ranges=()):
        """``events``: the profiler's kineto events; ``window_ns``: the
        window's bounds and ``host_ranges`` the harness's (start, end,
        label) ranges, on the host's wall clock, which is the
        profiler's."""
        self.ops: List[Tuple[int, int, str]] = [
            (e.start_ns(), e.end_ns(), e.name()) for e in events
            if _device_type(e) == "CUDA" and e.duration_ns() > 0]
        self.ranges = list(host_ranges)
        self.t0, self.t1 = window_ns
        self.ops = sorted((max(a, self.t0), min(b, self.t1), n)
                          for a, b, n in self.ops
                          if b > self.t0 and a < self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[int]] = []
        for a, b, _ in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        edges, prev = [], self.t0
        for a, b in self.busy_intervals():
            if a > prev:
                edges.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            edges.append((prev, self.t1))
        return edges

    def host_range_at(self, t: int) -> str:
        """The innermost harness range open on the host at ``t``."""
        best: Optional[Tuple[int, str]] = None
        for a, b, name in self.ranges:
            if a <= t < b and (best is None or b - a < best[0]):
                best = (b - a, name)
        return RANGES[best[1]] if best else "outside the harness's ranges"

    def longest_gaps(self, n: int = 10) -> List[list]:
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_range_at((a + b) // 2), (b - a) / 1e9]
                for a, b in gaps]

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for a, b, name in self.ops:
            out[_short(name)] += (b - a) / 1e9
        return dict(out)

    def top_ops(self, n: int = 10) -> List[list]:
        by = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in by[:n]]

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum((b - a) for a, b, name in self.ops
                   if rx.search(name)) / 1e9
