"""The one generator of the benchmark's traffic: a protocol run from the
parameters of a traffic file (``fedbench/traffic/<name>.json``).

A traffic mix of a federated simulation is the population and how it
works: how many clients, how fast each one runs, how long a message
takes, the wait gate ``d``, the block of local steps a client may take
in a tick, the round sizes ``s_i`` and round step sizes, and DP.  Every
size here is fixed by the file; the seed only picks the draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


def round_sizes(spec: dict) -> List[int]:
    """``spec["rounds"]`` round sizes: ``power`` is
    ``ceil(N_c * q * (i + m) ** p)`` (arXiv:2007.09208 Theorem 4's form),
    ``linear`` is ``s0 + ceil(a * i)``."""
    kind, n = spec["kind"], int(spec["rounds"])
    if kind == "power":
        return [max(1, int(math.ceil(spec["N_c"] * spec["q"]
                                     * (i + spec["m"]) ** spec["p"])))
                for i in range(n)]
    if kind == "linear":
        return [int(spec["s0"] + math.ceil(spec["a"] * i)) for i in range(n)]
    raise ValueError(f"unknown round size kind {kind!r}")


def round_steps(spec: dict, sizes: List[int]) -> List[float]:
    """Round step sizes: the step size at the round's first step,
    ``eta0 / (1 + beta t)`` (``inv_t``) or ``eta0 / (1 + beta sqrt t)``
    (``inv_sqrt``), t the steps of the earlier rounds."""
    out, t = [], 0
    for s in sizes:
        if spec["kind"] == "inv_t":
            out.append(spec["eta0"] / (1.0 + spec["beta"] * t))
        elif spec["kind"] == "inv_sqrt":
            out.append(spec["eta0"] / (1.0 + spec["beta"] * math.sqrt(t)))
        else:
            raise ValueError(f"unknown step kind {spec['kind']!r}")
        t += s
    return out


@dataclass
class Protocol:
    """A traffic file, read."""
    clients: int
    speeds: np.ndarray
    latency_s: Tuple[float, float]
    d: int
    block: int
    sizes: List[int]
    etas: List[float]
    dp_sigma: float
    dp_clip: float
    dp_round_clip: float
    dp_noise: str
    warm_ticks: int
    window_ticks: int

    @property
    def latency(self):
        """The simulator's ``latency=``: seconds, or a (lo, hi) range."""
        lo, hi = self.latency_s
        return lo if lo == hi else (lo, hi)

    @property
    def dt(self) -> float:
        """Seconds of one tick: the fastest client's block."""
        return self.block / float(self.speeds.max())

    def window(self, seconds: float, run_seconds: float) -> int:
        """The window's ticks: ``window_ticks`` in a window of the
        benchmark's ``run_seconds``, in proportion for a shorter or longer
        one.  A fixed amount of work, where a window that ended on the
        clock would run a tick more or less by the host's jitter, and
        that tick's useful steps differ from the average (rounds grow,
        and a tick's steps follow the credit)."""
        return max(1, round(self.window_ticks * seconds / run_seconds))

    @property
    def b_stat(self) -> int:
        """Local iterations the client block executes a block tick: the
        power of two at or above ``min(2 * block, largest round)``."""
        n = max(1, min(2 * self.block, max(self.sizes)))
        return 1 << (n - 1).bit_length()

    def steps_done(self, i: np.ndarray, h: np.ndarray) -> np.ndarray:
        """Local steps a client at round ``i``, offset ``h`` has completed
        since it started; rounds past the schedule repeat its last size."""
        s = np.asarray(self.sizes, np.int64)
        cum = np.concatenate([[0], np.cumsum(s)])
        i = np.asarray(i, np.int64)
        n = len(s)
        past = np.maximum(i - n, 0)
        return cum[np.minimum(i, n)] + past * s[-1] + np.asarray(h, np.int64)


def read(traffic: dict) -> Protocol:
    C = int(traffic["clients"])
    fleet = traffic["speeds"]
    speeds = (np.ones(C) if fleet == "uniform"
              else np.asarray(fleet, np.float64))
    if speeds.shape != (C,):
        raise ValueError(f"{len(speeds)} speeds for {C} clients")
    sizes = round_sizes(traffic["sizes"])
    dp = traffic.get("dp") or {}
    lat = traffic["latency_s"]
    lat = (float(lat), float(lat)) if np.isscalar(lat) else (
        float(lat[0]), float(lat[1]))
    return Protocol(
        clients=C, speeds=speeds, latency_s=lat, d=int(traffic["d"]),
        block=int(traffic["block"]), sizes=sizes,
        etas=round_steps(traffic["steps"], sizes),
        dp_sigma=float(dp.get("sigma", 0.0)),
        dp_clip=float(dp.get("clip", 0.0)),
        dp_round_clip=float(dp.get("round_clip", 0.0)),
        dp_noise=dp.get("noise", "operand"),
        warm_ticks=int(traffic["warm_ticks"]),
        window_ticks=int(traffic["window_ticks"]))
