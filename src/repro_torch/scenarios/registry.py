"""Scenario specs, the ``uniform`` preset, and the constant-tick plan.

A ``Scenario`` bundles message latency (``LatencyTable``), availability
and compute speed.  The port covers the reference's constant-tick path:
one latency table whose every bin quantizes to the same tick count at
the engine's ``dt`` (the ``uniform`` preset at the usual ``dt >= 0.1``),
full availability, caller-supplied speeds.  Tables that quantize to
several tick counts (sampled latency, the overflow bucket), churn and
speed models are ROADMAP Queue 1 item 7 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.scenarios.tables import LatencyTable

_ITEM7 = "ROADMAP Queue 1 item 7: remaining scenarios"


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclass(frozen=True)
class AlwaysOn:
    """Full availability — the default regime."""
    duty: float = 1.0


@dataclass(frozen=True)
class Scenario:
    """Heterogeneity spec: latency table, availability, speeds."""
    name: str
    latency: Any                    # LatencyTable
    availability: Any = AlwaysOn()
    speed_model: Optional[Any] = None
    ring_cap: int = 32

    def __post_init__(self):
        if not isinstance(self.latency, LatencyTable):
            raise NotImplementedError(
                f"per-client latency tables are not ported yet ({_ITEM7})")
        if not isinstance(self.availability, AlwaysOn):
            raise NotImplementedError(
                f"availability models are not ported yet ({_ITEM7})")
        if self.speed_model is not None:
            raise NotImplementedError(
                f"speed models are not ported yet ({_ITEM7})")
        if self.ring_cap < 2:
            raise ValueError("need ring_cap >= 2")

    def speeds(self, C: int, seed: int) -> Optional[np.ndarray]:
        return None


class ScenarioPlan:
    """One engine instance's view of a scenario at tick length ``dt``.

    Every message takes ``tick0`` ticks (the one quantized bin value),
    so ``update_ticks`` / ``broadcast_ticks`` are a constant [C] tensor
    and no latency key is drawn — the reference's ``_ticks_const`` path.
    """

    def __init__(self, scenario: Scenario, *, C: int, seed: int, dt: float,
                 device=None):
        self.scenario = scenario
        self.C = int(C)
        self.seed = int(seed)
        self.dt = float(dt)
        values = np.asarray(scenario.latency.values, np.float64)
        ticks = np.maximum(1, np.ceil(values / dt)).astype(np.int32)
        if not (ticks == ticks[0]).all():
            raise NotImplementedError(
                f"latency bins quantize to {sorted(set(ticks.tolist()))} "
                f"ticks at dt={dt}: sampled latency is not ported yet "
                f"({_ITEM7})")
        self.max_lat_ticks = int(ticks.max())
        self.ring_ticks = next_pow2(min(self.max_lat_ticks + 1,
                                        scenario.ring_cap))
        if self.max_lat_ticks >= self.ring_ticks:
            raise NotImplementedError(
                f"latency of {self.max_lat_ticks} ticks overflows the "
                f"{self.ring_ticks}-slot ring: the overflow bucket is not "
                f"ported yet ({_ITEM7})")
        self.far_tick_values: Tuple[int, ...] = ()
        self.duty = float(scenario.availability.duty)
        self.tick0 = int(ticks[0])
        self._tick0_c = torch.full((self.C,), self.tick0, dtype=torch.int32,
                                   device=device)

    def update_ticks(self, i: torch.Tensor) -> torch.Tensor:
        """Arrival-tick offsets of every client's round-``i[c]`` update."""
        return self._tick0_c

    def broadcast_ticks(self, k) -> torch.Tensor:
        """Per-client arrival-tick offsets of broadcast ``k``."""
        return self._tick0_c


def _uniform() -> Scenario:
    """The legacy default network: latency U(0.05, 0.1) virtual seconds,
    full availability, caller-supplied speeds."""
    return Scenario("uniform", LatencyTable.from_uniform(0.05, 0.1, 8))


_PRESETS = {"uniform": _uniform}


def get_scenario(spec) -> Scenario:
    """A ``Scenario`` passes through; a name looks up a preset."""
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, str):
        if spec in ("mobile_diurnal", "iot_straggler", "geo_regional",
                    "sensor_renewal"):
            raise NotImplementedError(
                f"scenario preset {spec!r} is not ported yet ({_ITEM7})")
        if spec not in _PRESETS:
            raise KeyError(f"unknown scenario {spec!r} "
                           f"(have {sorted(_PRESETS)})")
        return _PRESETS[spec]()
    raise TypeError(f"scenario must be a Scenario or preset name, "
                    f"got {type(spec).__name__}")


def legacy_latency_scenario(latency) -> Scenario:
    """``latency``: None (the ``uniform`` preset), a float (constant
    virtual seconds) or an ``(lo, hi)`` uniform range."""
    if callable(latency):
        raise TypeError("the device engine takes a latency scenario, "
                        "not a host callable")
    if latency is None:
        return get_scenario("uniform")
    if isinstance(latency, (int, float)):
        return Scenario(f"const:{latency}",
                        LatencyTable.constant(float(latency)))
    lo, hi = (float(latency[0]), float(latency[1]))
    if not 0.0 < lo <= hi:
        raise ValueError(
            f"latency=(lo, hi) needs 0 < lo <= hi, got ({lo}, {hi})")
    if lo == hi:
        return Scenario(f"const:{lo}", LatencyTable.constant(lo))
    return Scenario(f"uniform:{lo},{hi}",
                    LatencyTable.from_uniform(lo, hi, 8))
