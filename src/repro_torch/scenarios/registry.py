"""Scenario specs, named presets, trace ingestion and the engine plan
(the reference's ``repro/scenarios/registry.py``).

A ``Scenario`` bundles message latency (one ``LatencyTable`` or a tuple
of them with a ``TableAssignment``), availability and compute speed.
``ScenarioPlan`` is one engine instance's view at tick length ``dt``:
per-client ``[C, K]`` alias rows on the device, the near/far split of
the update ring, and message-addressed draws on the reference's key
chain, so the port draws the same arrival ticks:

    lat_base  = PRNGKey(seed ^ LAT_SALT)
    update    (c, i): fold_in(fold_in(fold_in(lat_base, 0), c), i)
    broadcast (k, c): fold_in(fold_in(fold_in(lat_base, 1), k), c)

Presets: ``uniform``, ``mobile_diurnal``, ``iot_straggler``,
``geo_regional`` and ``sensor_renewal``.  Without ``dt`` the plan serves
the event simulator: latency seconds from the same per-message bins.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.salts import LAT_SALT, TABLE_SALT
from repro_torch.scenarios.availability import (AlwaysOn, Churn, Diurnal,
                                                RegionalChurn, RenewalChurn,
                                                SpeedModel)
from repro_torch.scenarios.tables import (LatencyTable, alias_sample_rows,
                                          key_uniforms, vose_alias)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def draw_table_ids(C: int, T: int, weights, seed: int) -> np.ndarray:
    """[C] int32 table ids for ``TableAssignment("draw")``: one uniform
    per client from ``fold_in(PRNGKey(seed ^ TABLE_SALT), c)`` inverted
    through the normalized-weight CDF.  ``weights=None`` is uniform."""
    base = prng.PRNGKey(seed ^ TABLE_SALT)
    keys = prng.fold_in(base[None, :], torch.arange(C))
    u = prng.keys_uniform(keys, ())                          # [C]
    w = (torch.tensor(weights, dtype=torch.float32) if weights is not None
         else torch.ones(T, dtype=torch.float32))
    cum = prng.cumsum_xla(w / w.sum())
    return (u[:, None] >= cum[None, :-1]).sum(dim=1).to(torch.int32).numpy()


@dataclass(frozen=True)
class TableAssignment:
    """[C]-indexed mapping of clients onto a scenario's latency tables.

    kinds: ``cycle`` (client c uses table c % T), ``explicit`` (the full
    [C] tuple ``table_id``), ``draw`` (``draw_table_ids`` from
    ``weights``, uniform when omitted)."""
    kind: str = "cycle"
    table_id: Optional[Tuple[int, ...]] = None
    weights: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.kind not in ("cycle", "explicit", "draw"):
            raise ValueError(f"unknown table assignment kind "
                             f"{self.kind!r} (want cycle|explicit|draw)")
        if self.kind == "explicit":
            if self.table_id is None:
                raise ValueError("explicit table assignment needs "
                                 "table_id")
            object.__setattr__(self, "table_id",
                               tuple(int(x) for x in self.table_id))
        if self.weights is not None:
            w = tuple(float(x) for x in self.weights)
            if any(x < 0.0 for x in w) or not sum(w) > 0.0:
                raise ValueError("table assignment weights must be "
                                 "non-negative and sum to > 0")
            object.__setattr__(self, "weights", w)

    def resolve(self, C: int, T: int, seed: int) -> np.ndarray:
        """-> [C] int32 table ids, validated against C and T."""
        if self.kind == "explicit":
            if len(self.table_id) != C:
                raise ValueError(
                    f"table_id length {len(self.table_id)} does not "
                    f"match n_clients {C}")
            tid = np.asarray(self.table_id, np.int64)
            if tid.size and (tid.min() < 0 or tid.max() >= T):
                raise ValueError(
                    f"table_id entries must lie in [0, {T}); got range "
                    f"[{tid.min()}, {tid.max()}]")
            return tid.astype(np.int32)
        if self.kind == "draw":
            if self.weights is not None and len(self.weights) != T:
                raise ValueError(
                    f"need one weight per table: {len(self.weights)} "
                    f"weights for {T} tables")
            return draw_table_ids(C, T, self.weights, seed)
        return (np.arange(C) % T).astype(np.int32)


@dataclass(frozen=True)
class Scenario:
    """Heterogeneity spec: latency (one table or a tuple with an
    assignment), availability, speed model, and ``ring_cap``, the bound
    on the engine's update ring — draws quantizing past it spill into
    the overflow bucket."""
    name: str
    latency: Any                    # LatencyTable | tuple of LatencyTable
    availability: Any = field(default_factory=AlwaysOn)
    speed_model: Optional[SpeedModel] = None
    assignment: Optional[TableAssignment] = None
    ring_cap: int = 32

    def __post_init__(self):
        lat = self.latency
        if isinstance(lat, (list, tuple)):
            lat = tuple(lat)
            if not lat:
                raise ValueError("need at least one latency table")
            if not all(isinstance(t, LatencyTable) for t in lat):
                raise TypeError("latency tuple entries must be "
                                "LatencyTables")
            object.__setattr__(self, "latency", lat)
        elif not isinstance(lat, LatencyTable):
            raise TypeError(f"latency must be a LatencyTable or a tuple "
                            f"of them, got {type(lat).__name__}")
        if self.assignment is None and len(self.tables) > 1:
            object.__setattr__(self, "assignment", TableAssignment())
        if self.ring_cap < 2:
            raise ValueError("need ring_cap >= 2")

    @property
    def tables(self) -> Tuple[LatencyTable, ...]:
        lat = self.latency
        return lat if isinstance(lat, tuple) else (lat,)

    def speeds(self, C: int, seed: int) -> Optional[np.ndarray]:
        if self.speed_model is None:
            return None
        return self.speed_model.draw(C, seed)


class ScenarioPlan:
    """One engine instance's view of a scenario.

    With ``dt`` (the cohort engines): ``update_ticks(i)`` /
    ``broadcast_ticks(k)`` give [C] int32 arrival offsets (>= 1) on
    ``device``; ``avail_mask(t)`` a bool [C] mask, or is ``None`` when
    every client is always on.  When every client's table quantizes to
    one tick count (the ``uniform`` preset at the usual dt), the draws
    are skipped and one constant tensor is returned — the reference's
    ``_ticks_const`` path.  Broadcast draws are cached by ``k``: the
    engine asks for the few counters its cascade may fire next, and each
    is drawn once.  The host cohort engine reads the same draws as numpy
    (``host_update_ticks`` / ``host_broadcast_ticks`` / ``host_avail``).

    With ``dt=None`` (the event simulator): ``update_latencies_s(i)`` /
    ``broadcast_latencies_s(k)``, every client's latency in seconds from
    the same keys and bins, the bin value rounded through f32 as the
    reference gathers it.
    """

    def __init__(self, scenario: Scenario, *, C: int, seed: int,
                 dt: Optional[float] = None, device=None):
        self.scenario = scenario
        self.C = int(C)
        self.seed = int(seed)
        self.dt = None if dt is None else float(dt)
        self.device = device
        tables = scenario.tables
        self.T = len(tables)
        self.K = max(len(t.values) for t in tables)
        if scenario.assignment is not None:
            self.table_id = scenario.assignment.resolve(self.C, self.T, seed)
        else:
            self.table_id = np.zeros(self.C, np.int32)
        padded = [t.padded(self.K) for t in tables]
        vals_tk = np.stack([v for v, _ in padded])          # [T, K] f64
        aliases = [vose_alias(p) for _, p in padded]
        tid = self.table_id
        self._values_c = vals_tk[tid]                       # [C, K] f64
        self._prob_c = torch.tensor(
            np.stack([a[0] for a in aliases])[tid], device=device)
        self._alias_c = torch.tensor(
            np.stack([a[1] for a in aliases])[tid].astype(np.int64),
            device=device)
        cidx = torch.arange(self.C, dtype=torch.int64, device=device)
        self._cidx = cidx
        lat_base = prng.PRNGKey(seed ^ LAT_SALT)
        self._upd_base = prng.fold_in(lat_base, 0)
        self._bc_base = prng.fold_in(lat_base, 1)
        self._upd_client_keys = prng.fold_in(
            self._upd_base.to(device)[None, :], cidx)       # [C, 2]
        self._bc_cache: Dict[int, torch.Tensor] = {}
        self.duty = float(scenario.availability.duty)
        # per-client-constant seconds: every row is one effective bin, so
        # no draw; values round-trip through f32 like the sampled path
        self._const_s = bool((self._values_c == self._values_c[:, :1]).all())
        self._const_vals_s = self._values_c[:, 0].astype(
            np.float32).astype(np.float64)
        self._values_c_dev = torch.tensor(self._values_c, dtype=torch.float32,
                                          device=device)
        self._upd_s_cache: Dict[int, np.ndarray] = {}
        if self.dt is None:
            return

        tick_c = np.maximum(1, np.ceil(self._values_c / self.dt)
                            ).astype(np.int32)
        self.max_lat_ticks = int(tick_c.max())
        # near/far split: the update ring holds ring_ticks slots; draws
        # past it go to the overflow bucket.  far_tick_values is the set
        # of quantized bin values >= the boundary: it bounds how many
        # distinct far arrival ticks one completion tick can produce.
        self.ring_ticks = next_pow2(min(self.max_lat_ticks + 1,
                                        scenario.ring_cap))
        self.far_tick_values = tuple(
            int(v) for v in np.unique(tick_c[tick_c >= self.ring_ticks]))
        self._ticks_const = bool((tick_c == tick_c[:, :1]).all())
        self._tick0_c = torch.tensor(tick_c[:, 0], dtype=torch.int32,
                                     device=device)
        self._tick0_c_np = tick_c[:, 0].astype(np.int64)
        self._tick_vals_c = torch.tensor(tick_c, dtype=torch.int32,
                                         device=device)
        self.avail_mask: Optional[Callable[[int], torch.Tensor]] = \
            scenario.availability.tick_plan(self.C, self.dt, self.seed,
                                            device=device)
        self._avail_last: Tuple[Optional[torch.Tensor], Any] = (None, None)

    def for_clients(self, lo: int, hi: int) -> "ScenarioPlan":
        """The plan as the rank holding clients ``[lo, hi)`` sees it:
        ``update_ticks`` takes and ``broadcast_ticks`` / ``avail_mask``
        give ``[hi - lo]`` tensors, each the matching slice of the whole
        population's draw (every draw is addressed by the global client
        index).  The tick plan's global figures (ring, far values,
        latency tail, duty) are the whole plan's."""
        if (lo, hi) == (0, self.C):
            return self
        if self.dt is None:
            raise ValueError("a client range needs the cohort engines' "
                             "plan (dt set)")
        view = copy.copy(self)
        view.C = hi - lo
        for name in ("_prob_c", "_alias_c", "_cidx", "_upd_client_keys",
                     "_tick0_c", "_tick_vals_c"):
            setattr(view, name, getattr(self, name)[lo:hi])
        view._bc_cache = {}
        whole = self.avail_mask
        if whole is not None:
            last: list = [None, None]

            def avail_mask(t: int) -> torch.Tensor:
                m = whole(t)
                if m is not last[0]:
                    last[:] = [m, m[lo:hi]]
                return last[1]

            view.avail_mask = avail_mask
        return view

    def fingerprint(self):
        """Hashable identity for caches keyed on the plan: the plan is a
        pure function of (scenario, C, dt, seed), and the caller's cache
        key already carries C and seed."""
        return (self.scenario, self.dt)

    # -- tick-quantized draws ---------------------------------------------
    def _draw_bins(self, keys: torch.Tensor) -> torch.Tensor:
        """Per-client alias draw: the bin of each client's table row."""
        return alias_sample_rows(key_uniforms(keys), self._prob_c,
                                 self._alias_c)

    def _draw_ticks(self, keys: torch.Tensor) -> torch.Tensor:
        return torch.gather(self._tick_vals_c, 1,
                            self._draw_bins(keys)[:, None])[:, 0]

    def update_ticks(self, i: torch.Tensor) -> torch.Tensor:
        """Arrival-tick offsets of every client's round-``i[c]`` update
        ([C] int tensor on the plan's device -> [C] int32, each >= 1)."""
        if self._ticks_const:
            return self._tick0_c
        i = i.to(torch.int64)
        return self._draw_ticks(prng.fold_in(self._upd_client_keys, i))

    def broadcast_ticks(self, k: int) -> torch.Tensor:
        """Per-client arrival-tick offsets of broadcast ``k`` (a host int)
        -> [C] int32."""
        if self._ticks_const:
            return self._tick0_c
        k = int(k)
        hit = self._bc_cache.get(k)
        if hit is None:
            bk = prng.fold_in(self._bc_base, k).to(self.device)
            hit = self._draw_ticks(prng.fold_in(bk[None, :], self._cidx))
            self._bc_cache[k] = hit
            while len(self._bc_cache) > 64:   # counters only move up
                self._bc_cache.pop(min(self._bc_cache))
        return hit

    # -- the same draws as numpy (the host cohort engine) ------------------
    def host_update_ticks(self, i: np.ndarray) -> np.ndarray:
        if self._ticks_const:
            return self._tick0_c_np.copy()
        i_dev = torch.as_tensor(np.asarray(i, np.int64)).to(self.device)
        return self.update_ticks(i_dev).cpu().numpy().astype(np.int64)

    def host_broadcast_ticks(self, k: int) -> np.ndarray:
        if self._ticks_const:
            return self._tick0_c_np.copy()
        return self.broadcast_ticks(k).cpu().numpy().astype(np.int64)

    def host_avail(self, t: int) -> Optional[np.ndarray]:
        """``avail_mask(t)`` as numpy; a mask tensor the model returns
        again (one draw per churn epoch) is copied once."""
        if self.avail_mask is None:
            return None
        m = self.avail_mask(t)
        last, arr = self._avail_last
        if m is not last:
            arr = m.cpu().numpy()
            self._avail_last = (m, arr)
        return arr

    # -- continuous-seconds draws (the event simulator) --------------------
    def update_latencies_s(self, i: int) -> np.ndarray:
        """Every client's latency seconds for its round-``i`` update, in
        one draw per round (cached): the keys and bins of
        ``update_ticks``."""
        if self._const_s:
            return self._const_vals_s.copy()
        i = int(i)
        hit = self._upd_s_cache.get(i)
        if hit is None:
            keys = prng.fold_in(self._upd_client_keys, i)
            hit = self._gather_s(keys)
            self._upd_s_cache[i] = hit
            while len(self._upd_s_cache) > 16:   # rounds advance in order
                self._upd_s_cache.pop(next(iter(self._upd_s_cache)))
        return hit

    def update_latency_s(self, c: int, i: int) -> float:
        """Latency (virtual seconds) of client c's round-i update."""
        return float(self.update_latencies_s(i)[c])

    def broadcast_latencies_s(self, k: int) -> np.ndarray:
        """Every client's latency seconds for broadcast ``k``: the keys
        and bins of ``broadcast_ticks``."""
        if self._const_s:
            return self._const_vals_s.copy()
        k = int(k)
        bk = prng.fold_in(self._bc_base, k).to(self.device)
        return self._gather_s(prng.fold_in(bk[None, :], self._cidx))

    def _gather_s(self, keys: torch.Tensor) -> np.ndarray:
        j = self._draw_bins(keys)
        s = torch.gather(self._values_c_dev, 1, j[:, None])[:, 0]
        return s.cpu().numpy().astype(np.float64)


# plans are immutable (their draw caches aside): engines built on the same
# (scenario, C, seed, dt, device) share one
_PLAN_CACHE: Dict[Any, ScenarioPlan] = {}
_PLAN_CACHE_MAX = 32


def scenario_plan(scenario: Scenario, *, C: int, seed: int,
                  dt: Optional[float] = None, device=None) -> ScenarioPlan:
    """A cached ``ScenarioPlan``, least recently used dropped first."""
    key = (scenario, int(C), int(seed), dt, str(device))
    plan = _PLAN_CACHE.pop(key, None)
    if plan is None:
        plan = ScenarioPlan(scenario, C=C, seed=seed, dt=dt, device=device)
    _PLAN_CACHE[key] = plan
    while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    return plan


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Scenario]] = {}


def register_scenario(name: str):
    """Decorator: register a zero-arg Scenario builder under ``name``."""
    def deco(fn: Callable[[], Scenario]):
        _REGISTRY[name] = fn
        return fn
    return deco


def scenario_names():
    return sorted(_REGISTRY)


def get_scenario(spec) -> Scenario:
    """A ``Scenario`` passes through; a name looks up a preset."""
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, str):
        if spec not in _REGISTRY:
            raise KeyError(f"unknown scenario {spec!r} "
                           f"(have {scenario_names()})")
        return _REGISTRY[spec]()
    raise TypeError(f"scenario must be a Scenario or preset name, "
                    f"got {type(spec).__name__}")


@register_scenario("uniform")
def _uniform() -> Scenario:
    """The legacy default network: latency U(0.05, 0.1) virtual seconds,
    full availability, caller-supplied speeds."""
    return Scenario("uniform", LatencyTable.from_uniform(0.05, 0.1, 8))


@register_scenario("mobile_diurnal")
def _mobile_diurnal() -> Scenario:
    """Phone fleet: lognormal latency, diurnal windows with per-client
    phase, bimodal fast/slow devices."""
    return Scenario(
        "mobile_diurnal",
        LatencyTable.from_lognormal(median=0.3, sigma=0.8, n_bins=12),
        Diurnal(period_s=512.0, on_frac=0.75),
        SpeedModel(kind="bimodal", slow=0.3, slow_frac=0.3))


@register_scenario("iot_straggler")
def _iot_straggler() -> Scenario:
    """Sensor fleet: Pareto-tail latency, epoch churn, Zipf long-tail
    compute speeds."""
    return Scenario(
        "iot_straggler",
        LatencyTable.from_pareto(scale=0.1, alpha=1.2, n_bins=12,
                                 q_hi=0.99),
        Churn(p_available=0.9, epoch_s=64.0),
        SpeedModel(kind="zipf", alpha=0.5))


@register_scenario("geo_regional")
def _geo_regional() -> Scenario:
    """Geo-distributed fleet: two network populations assigned per
    client, with correlated regional outages."""
    return Scenario(
        "geo_regional",
        (LatencyTable.from_lognormal(median=0.08, sigma=0.4, n_bins=8),
         LatencyTable.from_lognormal(median=0.5, sigma=0.9, n_bins=8)),
        RegionalChurn(n_regions=4, p_available=0.9, p_region_up=0.95,
                      epoch_s=64.0),
        SpeedModel(kind="lognormal", sigma=0.4),
        assignment=TableAssignment("draw", weights=(0.6, 0.4)))


@register_scenario("sensor_renewal")
def _sensor_renewal() -> Scenario:
    """Duty-cycled sensor fleet: Pareto-tail latency plus renewal-process
    on/off churn."""
    return Scenario(
        "sensor_renewal",
        LatencyTable.from_pareto(scale=0.1, alpha=1.2, n_bins=12,
                                 q_hi=0.99),
        RenewalChurn(on_rate=1.0 / 16.0, off_rate=1.0 / 48.0),
        SpeedModel(kind="zipf", alpha=0.5))


def scenario_from_trace(path: str, *, name: Optional[str] = None,
                        availability=None,
                        speed_model: Optional[SpeedModel] = None,
                        n_bins: int = 16,
                        per_client: bool = False) -> Scenario:
    """A scenario whose latency table is fit to a measured trace
    (``LatencyTable.from_trace``); with ``per_client=True`` one table per
    trace client, engine client ``c`` using table ``c % T``."""
    avail = availability if availability is not None else AlwaysOn()
    if per_client:
        tables = LatencyTable.per_client_from_trace(path, n_bins=n_bins)
        return Scenario(name or f"trace:{path}", tables, avail, speed_model,
                        assignment=TableAssignment("cycle"))
    return Scenario(name or f"trace:{path}",
                    LatencyTable.from_trace(path, n_bins=n_bins), avail,
                    speed_model)


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
