"""Empirical latency tables: discrete distributions over message latency
in virtual seconds — K bin representatives plus probabilities.

Tables come from parametric fits (uniform, lognormal, Pareto tail,
mixtures) or from JSON/CSV traces of per-message seconds, and are sampled
by the alias method: one threefry key per draw gives two uniforms, a
column pick and an accept test, on the reference's key chains
(``repro/scenarios/tables.py``), so the port draws the same bins.  The
cohort engine quantizes bin values to tick counts (``tick_values``), so
a draw is an integer gather.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng


@dataclass(frozen=True)
class LatencyTable:
    """Discrete latency distribution: ascending bin values (virtual
    seconds) + probabilities.  Frozen and tuple-backed, so tables hash."""
    values: Tuple[float, ...]
    probs: Tuple[float, ...]

    def __post_init__(self):
        v = tuple(float(x) for x in self.values)
        p = tuple(float(x) for x in self.probs)
        if len(v) == 0 or len(v) != len(p):
            raise ValueError("values and probs must be equal-length and "
                             "non-empty")
        if any(x <= 0.0 for x in v):
            raise ValueError("latency bin values must be positive seconds")
        if any(b < a for a, b in zip(v, v[1:])):
            raise ValueError("latency bin values must be ascending")
        if any(x < 0.0 for x in p):
            raise ValueError("bin probabilities must be non-negative")
        tot = sum(p)
        if not tot > 0.0:
            raise ValueError("bin probabilities must sum to > 0")
        if abs(tot - 1.0) > 1e-9:     # idempotent: keeps an already-
            p = tuple(x / tot for x in p)   # normalized table bit-exact
        object.__setattr__(self, "values", v)
        object.__setattr__(self, "probs", p)

    # -- constructors ------------------------------------------------------
    @classmethod
    def constant(cls, seconds: float) -> "LatencyTable":
        return cls((float(seconds),), (1.0,))

    @classmethod
    def from_uniform(cls, lo: float, hi: float,
                     n_bins: int = 8) -> "LatencyTable":
        """Uniform(lo, hi) quantized to equal-width bins (centers)."""
        if not 0.0 < lo <= hi:
            raise ValueError(f"need 0 < lo <= hi, got ({lo}, {hi})")
        if hi == lo:
            return cls.constant(lo)
        edges = np.linspace(lo, hi, n_bins + 1)
        mids = 0.5 * (edges[:-1] + edges[1:])
        return cls(tuple(mids), (1.0 / n_bins,) * n_bins)

    @classmethod
    def from_samples(cls, samples: Sequence[float],
                     n_bins: int = 16) -> "LatencyTable":
        """Empirical histogram of observed per-message latencies."""
        s = np.asarray(list(samples), np.float64)
        if s.size == 0:
            raise ValueError("empty latency trace")
        if np.any(s <= 0.0) or not np.all(np.isfinite(s)):
            raise ValueError("trace latencies must be positive and finite")
        if float(s.min()) == float(s.max()):
            return cls.constant(float(s[0]))
        counts, edges = np.histogram(s, bins=n_bins)
        mids = 0.5 * (edges[:-1] + edges[1:])
        keep = counts > 0
        return cls(tuple(mids[keep]), tuple(counts[keep] / s.size))

    @classmethod
    def from_lognormal(cls, median: float, sigma: float, n_bins: int = 16,
                       spread: float = 3.0) -> "LatencyTable":
        """Lognormal fit: log-spaced bins over median * exp(±spread·σ),
        probabilities from the CDF (Φ via ``math.erf``), values at the
        geometric bin centers."""
        if median <= 0.0 or sigma <= 0.0:
            raise ValueError("need median > 0 and sigma > 0")
        z = np.linspace(-spread, spread, n_bins + 1)
        edges = median * np.exp(sigma * z)
        cdf = np.array([0.5 * (1.0 + math.erf(zz / math.sqrt(2.0)))
                        for zz in z])
        p = np.diff(cdf)
        p[0] += cdf[0]                 # fold both tails into the end bins
        p[-1] += 1.0 - cdf[-1]
        mids = np.sqrt(edges[:-1] * edges[1:])
        return cls(tuple(mids), tuple(p))

    @classmethod
    def from_pareto(cls, scale: float, alpha: float, n_bins: int = 16,
                    q_hi: float = 0.99) -> "LatencyTable":
        """Pareto(scale, alpha) heavy tail, truncated at quantile q_hi
        (the residual tail mass folds into the last bin)."""
        if scale <= 0.0 or alpha <= 0.0 or not 0.0 < q_hi < 1.0:
            raise ValueError("need scale > 0, alpha > 0, 0 < q_hi < 1")
        qs = np.linspace(0.0, q_hi, n_bins + 1)
        edges = scale * (1.0 - qs) ** (-1.0 / alpha)   # closed-form ppf
        p = np.diff(qs)
        p[-1] += 1.0 - q_hi
        mids = np.sqrt(edges[:-1] * edges[1:])
        return cls(tuple(mids), tuple(p))

    @classmethod
    def mix(cls, tables: Sequence["LatencyTable"],
            weights: Sequence[float]) -> "LatencyTable":
        """Mixture of tables (e.g. bimodal wifi/cellular latency)."""
        if len(tables) != len(weights) or not tables:
            raise ValueError("need one weight per table")
        pairs = sorted(
            (v, w * p) for t, w in zip(tables, weights)
            for v, p in zip(t.values, t.probs))
        return cls(tuple(v for v, _ in pairs), tuple(p for _, p in pairs))

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"values": list(self.values),
                           "probs": list(self.probs)})

    @classmethod
    def from_json(cls, text: str) -> "LatencyTable":
        obj = json.loads(text)
        return cls(tuple(obj["values"]), tuple(obj["probs"]))

    @classmethod
    def from_trace(cls, path: str, n_bins: int = 16) -> "LatencyTable":
        """Ingest a latency trace file.

        JSON: a bare list of per-message seconds, an object with a
        ``latency_s`` list, or a quantized ``{"values", "probs"}`` table.
        CSV: headerless, one latency per row (first column); or with a
        header row, the ``latency_s`` column (a header without one is an
        error — guessing a column would silently ingest wrong data).
        """
        ext = os.path.splitext(path)[1].lower()
        if ext not in (".json", ".csv"):
            raise ValueError(f"unsupported trace format {ext!r} "
                             "(want .json or .csv)")
        with open(path) as f:
            text = f.read()
        if ext == ".json":
            obj = json.loads(text)
            if isinstance(obj, dict) and "values" in obj:
                return cls(tuple(obj["values"]), tuple(obj["probs"]))
            samples = obj["latency_s"] if isinstance(obj, dict) else obj
            return cls.from_samples(samples, n_bins=n_bins)
        rows = [r.strip() for r in text.splitlines() if r.strip()]
        if not rows:
            raise ValueError(f"empty latency trace {path!r}")
        cells = [r.split(",") for r in rows]
        col = 0
        try:
            float(cells[0][0])
        except ValueError:                           # header row
            names = [c.strip() for c in cells[0]]
            if "latency_s" not in names:
                raise ValueError(
                    f"CSV trace header {names} has no 'latency_s' "
                    "column; refusing to guess which column holds the "
                    "latencies")
            col = names.index("latency_s")
            cells = cells[1:]
        if not cells:
            raise ValueError(f"empty latency trace {path!r} "
                             "(header but no data rows)")
        return cls.from_samples([float(r[col]) for r in cells],
                                n_bins=n_bins)

    @classmethod
    def per_client_from_trace(cls, path: str, n_bins: int = 16
                              ) -> Tuple["LatencyTable", ...]:
        """One table per distinct client of a trace keyed by device (JSON
        ``clients`` mapping, or CSV with ``client`` + ``latency_s``
        columns), ordered by sorted client id (numeric when the ids
        parse as numbers)."""
        ext = os.path.splitext(path)[1].lower()
        if ext not in (".json", ".csv"):
            raise ValueError(f"unsupported trace format {ext!r} "
                             "(want .json or .csv)")
        with open(path) as f:
            text = f.read()
        groups: dict = {}
        if ext == ".json":
            obj = json.loads(text)
            if not isinstance(obj, dict) or "clients" not in obj:
                raise ValueError(
                    "per-client JSON trace needs a 'clients' mapping of "
                    "client id -> [latency_s, ...]")
            groups = {str(k): list(v) for k, v in obj["clients"].items()}
        else:
            rows = [r.strip() for r in text.splitlines() if r.strip()]
            if not rows:
                raise ValueError(f"empty latency trace {path!r}")
            names = [c.strip() for c in rows[0].split(",")]
            if "client" not in names or "latency_s" not in names:
                raise ValueError(
                    f"per-client CSV trace header {names} needs both a "
                    "'client' and a 'latency_s' column")
            ci, li = names.index("client"), names.index("latency_s")
            for r in rows[1:]:
                c = r.split(",")
                groups.setdefault(c[ci].strip(), []).append(float(c[li]))
        if not groups:
            raise ValueError(f"empty latency trace {path!r}")

        def order(k):
            try:
                return (0, float(k), k)
            except ValueError:
                return (1, 0.0, k)

        return tuple(cls.from_samples(groups[k], n_bins=n_bins)
                     for k in sorted(groups, key=order))

    # -- stats -------------------------------------------------------------
    def mean(self) -> float:
        return sum(v * p for v, p in zip(self.values, self.probs))

    def quantile(self, q: float) -> float:
        acc = 0.0
        for v, p in zip(self.values, self.probs):
            acc += p
            if acc >= q:
                return v
        return self.values[-1]

    @property
    def max_s(self) -> float:
        return self.values[-1]

    # -- engine-facing views ----------------------------------------------
    def tick_values(self, dt: float) -> np.ndarray:
        """Bin values quantized to arrival-tick offsets, ``max(1,
        ceil(s / dt))``."""
        v = np.asarray(self.values, np.float64)
        return np.maximum(1, np.ceil(v / dt)).astype(np.int32)

    def alias_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Vose alias decomposition -> (prob f32 [K], alias i32 [K])."""
        return vose_alias(self.probs)

    def padded(self, K: int) -> Tuple[np.ndarray, np.ndarray]:
        """(values f64 [K], probs f64 [K]) padded to K bins with
        zero-probability copies of the last bin: a padded table samples
        exactly like the original."""
        n = len(self.values)
        if K < n:
            raise ValueError(f"cannot pad a {n}-bin table down to {K}")
        v = np.asarray(self.values + (self.values[-1],) * (K - n))
        p = np.asarray(self.probs + (0.0,) * (K - n))
        return v, p


def vose_alias(probs) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias decomposition of a probability vector (zero-probability
    padding bins allowed) -> (prob f32 [K], alias i32 [K])."""
    K = len(probs)
    p = np.asarray(probs, np.float64) * K
    prob = np.zeros(K, np.float64)
    alias = np.zeros(K, np.int64)
    small = [i for i in range(K) if p[i] < 1.0]
    large = [i for i in range(K) if p[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = p[s]
        alias[s] = l
        p[l] = (p[l] + p[s]) - 1.0
        (small if p[l] < 1.0 else large).append(l)
    for i in large + small:       # numerical leftovers: certain bins
        prob[i] = 1.0
        alias[i] = i
    return prob.astype(np.float32), alias.astype(np.int32)


def key_uniforms(keys: torch.Tensor) -> torch.Tensor:
    """[N, 2] threefry keys -> [N, 2] uniforms in [0, 1)."""
    return prng.keys_uniform(keys, (2,))


def alias_sample(u: torch.Tensor, prob: torch.Tensor,
                 alias: torch.Tensor) -> torch.Tensor:
    """Alias-method draw: ``u`` [..., 2] uniforms -> bin indices (int64).
    u[..., 0] picks a column, u[..., 1] runs the accept test."""
    K = prob.shape[0]
    j0 = torch.clamp((u[..., 0] * K).to(torch.int32), max=K - 1).long()
    return torch.where(u[..., 1] < prob[j0], j0, alias[j0].long())


def alias_sample_rows(u: torch.Tensor, prob: torch.Tensor,
                      alias: torch.Tensor) -> torch.Tensor:
    """Per-row alias draw for stacked tables: ``u`` [..., 2] against
    row-matched ``prob`` / ``alias`` [..., K] -> bin indices (int64).
    Same arithmetic as ``alias_sample``."""
    K = prob.shape[-1]
    j0 = torch.clamp((u[..., 0] * K).to(torch.int32), max=K - 1).long()
    p0 = torch.gather(prob, -1, j0[..., None])[..., 0]
    a0 = torch.gather(alias, -1, j0[..., None])[..., 0]
    return torch.where(u[..., 1] < p0, j0, a0.long())


def implied_probs(prob: np.ndarray, alias: np.ndarray) -> np.ndarray:
    """Probability of each bin under exact alias sampling:
    ``implied_probs(*t.alias_arrays()) == t.probs``."""
    K = len(prob)
    out = np.asarray(prob, np.float64).copy()
    for i in range(K):
        out[alias[i]] += 1.0 - prob[i]
    return out / K
