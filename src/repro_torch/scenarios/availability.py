"""Client availability and fleet-speed models (the reference's
``repro/scenarios/availability.py``).

Availability answers "is client c on at tick t?": ``tick_plan(C, dt,
seed, device)`` returns ``mask(t) -> bool [C]`` for a host-known tick,
or ``None`` when every client is always on.  The draws sit on the
reference's key chains and are pure functions of (epoch, client), so the
masks are the reference's, and a mask computes its per-epoch draws once
and keeps them on the device (``_EpochCache``).  Availability gates
compute and upload: an off client accrues no credit, takes no step and
sends no update; broadcast pickup is never gated.

``windows(C, seed)`` is the continuous-time form the event simulator
integrates (on-time over an interval and its inverse), for the models
whose windows are deterministic: diurnal windows exactly (numpy over
float64 phases), renewal churn as the true alternating renewal process
on the same per-(client, epoch) draws as its tick mask.  The epoch-hash
churn models (``Churn``, ``RegionalChurn``) have no continuous form, and
their ``windows`` raise.

Speed models draw the per-client iterations/second vector once, with
numpy, exactly as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analysis.salts import (AVAIL_SALT, PHASE_SALT,
                                        REGION_SALT, RENEW_SALT, SPEED_SALT)

class _EpochCache:
    """Per-epoch device tensors of a tick mask, kept for the two most
    recent epochs (a tick and the fuse preview of the next one)."""

    def __init__(self, draw: Callable[[int], object]):
        self._draw = draw
        self._ent: Dict[int, object] = {}

    def __call__(self, e: int):
        ent = self._ent.get(e)
        if ent is None:
            ent = self._ent[e] = self._draw(e)
            while len(self._ent) > 2:
                self._ent.pop(min(self._ent))
        return ent


@dataclass(frozen=True)
class AlwaysOn:
    """Full availability — the default regime."""
    duty: float = 1.0
    event_supported: bool = True

    def tick_plan(self, C: int, dt: float, seed: int, device=None) -> None:
        return None

    def windows(self, C: int, seed: int) -> None:
        return None


class _DiurnalWindows:
    """Continuous-time periodic on/off windows for the event simulator:
    client c is on during [k·P − φ_c, k·P − φ_c + on) for integer k."""

    def __init__(self, phase_s: np.ndarray, period_s: float, on_s: float):
        self.phase_s = phase_s
        self.period_s = float(period_s)
        self.on_s = float(on_s)

    def _cum_on(self, c: int, t: float) -> float:
        """Cumulative on-seconds of client c over (-inf, t]."""
        tt = t + self.phase_s[c]
        k, r = divmod(tt, self.period_s)
        return k * self.on_s + min(r, self.on_s)

    def on_time(self, c: int, t0: float, t1: float) -> float:
        """On-seconds inside [t0, t1]."""
        return max(0.0, self._cum_on(c, t1) - self._cum_on(c, t0))

    def advance(self, c: int, t0: float, work_s: float) -> float:
        """Earliest t with ``on_time(c, t0, t) == work_s`` (inverse)."""
        if work_s <= 0.0:
            return t0
        target = self._cum_on(c, t0) + work_s
        k, r = divmod(target, self.on_s)
        if r == 0.0:                  # lands exactly on a window end
            k, r = k - 1.0, self.on_s
        return k * self.period_s + r - self.phase_s[c]


@dataclass(frozen=True)
class Diurnal:
    """Periodic on/off windows with a per-client phase: each client is on
    for ``on_frac`` of every ``period_s`` virtual seconds, phases drawn
    uniformly from the engine seed."""
    period_s: float = 512.0
    on_frac: float = 0.75
    event_supported: bool = True

    def __post_init__(self):
        if self.period_s <= 0.0 or not 0.0 < self.on_frac <= 1.0:
            raise ValueError("need period_s > 0 and 0 < on_frac <= 1")

    @property
    def duty(self) -> float:
        return self.on_frac

    def _phases(self, C: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed ^ PHASE_SALT)
        return rng.uniform(0.0, self.period_s, C)

    def tick_plan(self, C: int, dt: float, seed: int,
                  device=None) -> Optional[Callable]:
        if self.on_frac >= 1.0:
            return None
        period_t = max(2, int(round(self.period_s / dt)))
        on_t = min(period_t - 1, max(1, int(round(self.on_frac * period_t))))
        phase_t = torch.tensor(
            np.floor(self._phases(C, seed) / dt).astype(np.int64) % period_t,
            dtype=torch.int64, device=device)

        def mask(t: int) -> torch.Tensor:
            return (phase_t + int(t)) % period_t < on_t

        return mask

    def windows(self, C: int, seed: int) -> Optional[_DiurnalWindows]:
        if self.on_frac >= 1.0:
            return None
        return _DiurnalWindows(self._phases(C, seed), self.period_s,
                               self.on_frac * self.period_s)


@dataclass(frozen=True)
class Churn:
    """Epoch churn: every ``epoch_s`` virtual seconds each client
    independently re-draws availability with probability
    ``p_available`` — uniform bits from ``fold_in(PRNGKey(seed ^
    AVAIL_SALT), epoch)``, a pure function of (epoch, client)."""
    p_available: float = 0.9
    epoch_s: float = 64.0
    event_supported: bool = False

    def __post_init__(self):
        if not 0.0 < self.p_available <= 1.0 or self.epoch_s <= 0.0:
            raise ValueError("need 0 < p_available <= 1 and epoch_s > 0")

    @property
    def duty(self) -> float:
        return self.p_available

    def tick_plan(self, C: int, dt: float, seed: int,
                  device=None) -> Optional[Callable]:
        if self.p_available >= 1.0:
            return None
        epoch_t = max(1, int(round(self.epoch_s / dt)))
        base = prng.PRNGKey(seed ^ AVAIL_SALT)
        p = float(np.float32(self.p_available))
        draws = _EpochCache(lambda e: prng.uniform(
            prng.fold_in(base, e), (C,), device=device) < p)
        return lambda t: draws(int(t) // epoch_t)

    def windows(self, C: int, seed: int):
        raise ValueError(
            "Churn availability is tick-hash addressed and has no "
            "continuous-time form; the event simulator cannot run it — "
            "use the cohort engines (engine='cohort'|'device')")


@dataclass(frozen=True)
class RegionalChurn:
    """Correlated churn: client c is on in an epoch iff its region is up
    (a shared per-(epoch, region) uniform against ``p_region_up``) AND its
    own draw passes (the ``Churn`` chain against ``p_available /
    p_region_up``), so the marginal duty is ``p_available``.  Regions
    come from ``region_of`` or default to ``n_regions`` contiguous equal
    blocks of the client axis."""
    n_regions: int = 4
    p_available: float = 0.9
    p_region_up: float = 0.95
    epoch_s: float = 64.0
    region_of: Optional[tuple] = None
    event_supported: bool = False

    def __post_init__(self):
        if self.n_regions < 1:
            raise ValueError("need n_regions >= 1")
        if not 0.0 < self.p_available <= self.p_region_up <= 1.0:
            raise ValueError(
                "need 0 < p_available <= p_region_up <= 1 (the marginal "
                "duty cannot exceed the region-up probability)")
        if self.epoch_s <= 0.0:
            raise ValueError("need epoch_s > 0")
        if self.region_of is not None:
            r = tuple(int(x) for x in self.region_of)
            if any(not 0 <= x < self.n_regions for x in r):
                raise ValueError(
                    f"region_of ids must lie in [0, {self.n_regions}); "
                    f"got {sorted(set(self.region_of))}")
            object.__setattr__(self, "region_of", r)

    @property
    def duty(self) -> float:
        return self.p_available

    def regions(self, C: int) -> np.ndarray:
        if self.region_of is not None:
            if len(self.region_of) != C:
                raise ValueError(
                    f"region_of has {len(self.region_of)} entries for "
                    f"{C} clients")
            return np.asarray(self.region_of, np.int32)
        return (np.arange(C) * self.n_regions // C).astype(np.int32)

    def tick_plan(self, C: int, dt: float, seed: int,
                  device=None) -> Optional[Callable]:
        if self.p_available >= 1.0:
            return None
        epoch_t = max(1, int(round(self.epoch_s / dt)))
        base_c = prng.PRNGKey(seed ^ AVAIL_SALT)
        base_r = prng.PRNGKey(seed ^ REGION_SALT)
        reg = torch.tensor(self.regions(C), dtype=torch.int64, device=device)
        # the reference's f32 operands: p_available / p_region_up is
        # divided in float64 and rounded once
        p_client = float(np.float32(self.p_available / self.p_region_up))
        p_reg = float(np.float32(self.p_region_up))
        R = self.n_regions

        def draw(e: int) -> torch.Tensor:
            ur = prng.uniform(prng.fold_in(base_r, e), (R,), device=device)
            uc = prng.uniform(prng.fold_in(base_c, e), (C,), device=device)
            return (ur[reg] < p_reg) & (uc < p_client)

        draws = _EpochCache(draw)
        return lambda t: draws(int(t) // epoch_t)

    def windows(self, C: int, seed: int):
        raise ValueError(
            "RegionalChurn is tick-hash addressed and has no "
            "continuous-time form; the event simulator cannot run it — "
            "use the cohort engines (engine='cohort'|'device'), or "
            "RenewalChurn for a churn model the event simulator "
            "integrates")


def _renewal_epoch_draw(base: torch.Tensor, e: int, C: int, N: int,
                        duty: float, on_rate: float, off_rate: float,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(client, epoch) renewal schedule: stationary-Bernoulli(duty)
    initial states ``init_on [C]`` and f32 cumulative switch times
    ``cs [C, N]`` (seconds from the epoch start) from N exponential
    holdings on the ``fold_in(fold_in(base, epoch), client)`` chain.

    The uniforms are the reference's bits; the holding times go through
    torch's ``log1p``, which differs from XLA's CPU ``log1p`` by an ulp
    on a few percent of inputs, so ``cs`` agrees to an ulp or two and a
    mask bit could differ only where a tick lands within that gap of a
    switch time."""
    cidx = torch.arange(C, dtype=torch.int64, device=device)
    keys = prng.fold_in(prng.fold_in(base, e).to(device)[None, :], cidx)
    u = prng.keys_uniform(keys, (N + 1,))                    # [C, N + 1]
    j_odd = (torch.arange(N, device=device) % 2) == 1
    init_on = u[:, 0] < duty
    state_on = init_on[:, None] ^ j_odd[None, :]
    rate = torch.where(state_on,
                       torch.tensor(np.float32(off_rate), device=device),
                       torch.tensor(np.float32(on_rate), device=device))
    dur = -torch.log1p(-u[:, 1:]) / rate
    return init_on, prng.cumsum_xla(dur)


class _RenewalWindows:
    """Continuous-time alternating-renewal on/off windows for the event
    simulator, on the tick mask's draws: time splits into epochs of
    ``E_s = epoch_cycles * mean_cycle_s`` seconds, and each epoch's
    per-client initial state and switch times come from the same
    ``_renewal_epoch_draw`` chain (computed on the CPU).  Where the tick
    ``dt`` divides ``E_s``, tick t of the cohort engines and second
    ``t * dt`` here land in the same epoch at the same offset, so
    ``on_at`` reproduces the tick mask elementwise.  Past the N-th switch
    of an epoch the state clamps to the post-N parity, as the mask's
    switch count does."""

    def __init__(self, av: "RenewalChurn", C: int, seed: int):
        self.C = int(C)
        self.N = int(av.n_draws)
        self.E_s = float(av.epoch_cycles * av.mean_cycle_s)
        self._base = prng.PRNGKey(seed ^ RENEW_SALT)
        self._duty = float(np.float32(av.duty))
        self._on_rate = float(av.on_rate)
        self._off_rate = float(av.off_rate)
        self._epochs: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._pref = [[0.0] for _ in range(C)]  # on-secs over epochs [0, i)

    def _epoch(self, e: int):
        ent = self._epochs.get(e)
        if ent is None:
            init_on, cs = _renewal_epoch_draw(
                self._base, e, self.C, self.N, self._duty, self._on_rate,
                self._off_rate)
            ent = (init_on.numpy(), cs.numpy())
            self._epochs[e] = ent
        return ent

    def on_at(self, c: int, t: float) -> bool:
        """State of client c at second t — the tick mask's expression
        (f32 ``cs <= tau`` switch counting)."""
        e = int(t // self.E_s)
        init_on, cs = self._epoch(e)
        tau = np.float32(t - e * self.E_s)
        ndone = int(np.sum(cs[c] <= tau))
        return bool(init_on[c]) ^ (ndone % 2 == 1)

    def _walk(self, c: int, e: int, tau: float,
              need: Optional[float] = None) -> float:
        """Segment walk inside epoch e.  With ``need=None``: on-seconds
        of client c over epoch offsets [0, tau].  With ``need``: the
        smallest offset at which that many on-seconds have accrued."""
        init_on, cs = self._epoch(e)
        sw = cs[c].astype(np.float64)
        on, acc, prev = bool(init_on[c]), 0.0, 0.0
        for j in range(self.N):
            hi = min(float(sw[j]), tau)
            if hi > prev:
                if on:
                    if need is not None and acc + (hi - prev) >= need:
                        return prev + (need - acc)
                    acc += hi - prev
                prev = hi
            if sw[j] >= tau:
                break
            on = not on
        else:
            # post-N clamp segment up to the epoch-offset horizon
            if tau > prev and on:
                if need is not None and acc + (tau - prev) >= need:
                    return prev + (need - acc)
                acc += tau - prev
        if need is not None:
            raise ValueError(
                f"epoch {e} holds only {acc} on-seconds for client {c}, "
                f"need {need}")
        return acc

    def _prefix(self, c: int, e: int) -> float:
        """Cumulative on-seconds of client c over the e full epochs."""
        pl = self._pref[c]
        while len(pl) <= e:
            pl.append(pl[-1] + self._walk(c, len(pl) - 1, self.E_s))
        return pl[e]

    def _cum(self, c: int, t: float) -> float:
        """Cumulative on-seconds of client c over [0, t]."""
        if t <= 0.0:
            return 0.0
        e = int(t // self.E_s)
        return self._prefix(c, e) + self._walk(c, e, t - e * self.E_s)

    def on_time(self, c: int, t0: float, t1: float) -> float:
        return max(0.0, self._cum(c, t1) - self._cum(c, t0))

    def advance(self, c: int, t0: float, work_s: float) -> float:
        """Earliest t with ``on_time(c, t0, t) == work_s`` (inverse)."""
        if work_s <= 0.0:
            return t0
        target = self._cum(c, t0) + work_s
        e = max(int(t0 // self.E_s), 0)
        while self._prefix(c, e + 1) < target:
            e += 1
        need = target - self._prefix(c, e)
        return e * self.E_s + self._walk(c, e, self.E_s, need=need)


@dataclass(frozen=True)
class RenewalChurn:
    """Churn as an alternating renewal process: each client holds ON for
    Exp(off_rate) seconds, then OFF for Exp(on_rate) seconds.  Time
    splits into epochs of ``epoch_cycles`` mean cycles; within an epoch
    the schedule is an exact renewal path from (client, epoch)-addressed
    draws (``_renewal_epoch_draw``)."""
    on_rate: float = 1.0 / 16.0
    off_rate: float = 1.0 / 48.0
    epoch_cycles: float = 4.0
    n_draws: int = 24
    event_supported: bool = True

    def __post_init__(self):
        if self.on_rate <= 0.0 or self.off_rate <= 0.0:
            raise ValueError("need on_rate > 0 and off_rate > 0")
        if self.epoch_cycles <= 0.0 or self.n_draws < 2:
            raise ValueError("need epoch_cycles > 0 and n_draws >= 2")
        if self.n_draws < 4 * self.epoch_cycles:
            raise ValueError(
                f"n_draws={self.n_draws} cannot cover epoch_cycles="
                f"{self.epoch_cycles} (need >= 4 * epoch_cycles)")

    @property
    def duty(self) -> float:
        return self.on_rate / (self.on_rate + self.off_rate)

    @property
    def mean_cycle_s(self) -> float:
        return 1.0 / self.on_rate + 1.0 / self.off_rate

    def tick_plan(self, C: int, dt: float, seed: int,
                  device=None) -> Optional[Callable]:
        epoch_t = max(1, int(round(self.epoch_cycles * self.mean_cycle_s
                                   / dt)))
        base = prng.PRNGKey(seed ^ RENEW_SALT)
        N = int(self.n_draws)
        duty = float(np.float32(self.duty))
        dt32 = np.float32(dt)
        draws = _EpochCache(lambda e: _renewal_epoch_draw(
            base, e, C, N, duty, self.on_rate, self.off_rate, device))

        def mask(t: int) -> torch.Tensor:
            e = int(t) // epoch_t
            # (t - e * epoch_t) as f32 times f32 dt, one rounding, as the
            # reference computes tau
            tau = float(np.float32(t - e * epoch_t) * dt32)
            init_on, cs = draws(e)
            ndone = (cs <= tau).sum(dim=1)
            return init_on ^ (ndone % 2 == 1)

        return mask

    def windows(self, C: int, seed: int) -> "_RenewalWindows":
        return _RenewalWindows(self, C, seed)


@dataclass(frozen=True)
class SpeedModel:
    """Per-client iterations/second draw, normalized so max(speed) = 1.

    kinds: uniform U(lo, hi); bimodal (slow with prob slow_frac);
    zipf 1 / rank^alpha over a random permutation; lognormal
    exp(sigma * N(0, 1)).
    """
    kind: str = "uniform"
    lo: float = 0.5
    hi: float = 1.0
    slow: float = 0.25
    slow_frac: float = 0.3
    alpha: float = 0.8
    sigma: float = 0.5
    min_speed: float = 1e-3

    def draw(self, C: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed ^ SPEED_SALT)
        if self.kind == "uniform":
            s = rng.uniform(self.lo, self.hi, C)
        elif self.kind == "bimodal":
            s = np.where(rng.random(C) < self.slow_frac, self.slow, 1.0)
        elif self.kind == "zipf":
            ranks = rng.permutation(C) + 1
            s = ranks.astype(np.float64) ** (-self.alpha)
        elif self.kind == "lognormal":
            s = np.exp(self.sigma * rng.standard_normal(C))
        else:
            raise ValueError(f"unknown speed model kind {self.kind!r}")
        s = np.maximum(s, self.min_speed)
        return s / s.max()
