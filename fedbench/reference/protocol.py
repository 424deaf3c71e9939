"""The simulated protocol written out plainly, tick by tick.

The paper's asynchronous FL protocol (Algorithms 1-4 of
arXiv:2007.09208) as a cohort simulator steps it: every client runs its
rounds of local SGD at a fixed credit of steps a tick, sends its round's
update (clipped and noised under DP) when the round is done, the server
applies each tick's arrivals and broadcasts a new model once every
client's update of its current round has arrived, and a client stays at
most ``d`` rounds ahead of the freshest model it has received.

Written from the protocol, not from the program: plain Python over
dictionaries for the messages in flight, numpy for the per-client
integers, plain torch for the floats.  It covers traffic whose update
and broadcast latency is the same whole number of ticks for every
message (the benchmark's traffic is such), and the paper's aggregation
(every update applied as it arrives).

Fixed-point credit: a client earns ``round(speed / max speed * 2**16) *
block`` sixty-five-thousandths of a step a tick; a finished round keeps
at most ``block`` steps of credit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from fedbench.reference import threefry

FRAC = 16
NOISE_SALT = 0x5EED
# the census, in its order
OPS = ("ticks", "block_ticks", "bucket_applies", "cascade_ticks",
       "deliver_ticks", "deliver_rows", "ring_scatters", "complete_ticks",
       "far_ticks", "far_groups")


def latency_ticks(lat_lo: float, lat_hi: float, dt: float) -> int:
    """Ticks a message takes when every latency in [lo, hi] rounds up to
    the same tick count; other traffic is outside this reference."""
    lo = max(1, math.ceil(lat_lo / dt))
    hi = max(1, math.ceil(lat_hi / dt))
    if lo != hi:
        raise NotImplementedError(
            f"latency [{lat_lo}, {lat_hi}] s spans {lo}..{hi} ticks of "
            f"{dt} s: the plain protocol covers one tick count")
    return lo


class PlainCohort:
    """State and tick of the protocol.  ``block_fn(w, U, i, h, n, eta)``
    runs ``n[c]`` local steps of client ``c`` from offset ``h[c]`` of
    round ``i[c]`` on its rows of ``w`` and ``U`` in place; ``v0`` is the
    starting model; the noise of a finished round is
    ``noise_scale`` times the tick key's normals, by ``noise``."""

    def __init__(self, *, v0: torch.Tensor, C: int, sizes: List[int],
                 etas: List[float], d: int, block: int, speeds,
                 lat_ticks: int, seed: int, noise_scale: float,
                 block_fn: Callable, noise: str = "operand",
                 dtype=torch.float32):
        self.C, self.D = C, v0.shape[0]
        self.dev = v0.device
        self.dtype = dtype
        self.sizes = np.asarray(sizes, np.int64)
        self.etas = torch.tensor(np.asarray(etas, np.float32),
                                 device=self.dev)
        self.d, self.block, self.lat = int(d), int(block), int(lat_ticks)
        sp = np.asarray(speeds, np.float64)
        self.accrual = (np.maximum(1, np.round(sp / sp.max() * (1 << FRAC)))
                        .astype(np.int64) * self.block)
        self.noise_key = threefry.key(seed ^ NOISE_SALT)
        self.noise_scale = float(noise_scale)
        # operand: erfinv normals; in_kernel: Box-Muller counter normals
        self.normals = {"operand": threefry.normal,
                        "in_kernel": threefry.box_muller}[noise]
        self.block_fn = block_fn
        self.v = v0.to(dtype).clone()
        self.w = self.v[None, :].repeat(C, 1)
        self.U = torch.zeros_like(self.w)
        z = lambda: np.zeros(C, np.int64)  # noqa: E731
        self.i, self.h, self.k, self.credit = z(), z(), z(), z()
        self.t = self.server_k = self.messages = self.broadcasts = 0
        self.ops = dict.fromkeys(OPS, 0)
        self.H: Dict[int, int] = {}            # round -> updates received
        self.pending: Dict[int, dict] = {}     # arrival tick -> sum, counts
        self.bcasts: List[dict] = []           # k, model, arrival tick

    def step(self) -> None:
        """One tick."""
        self.t += 1
        t, C = self.t, self.C
        arr = self.pending.pop(t, None)
        for r, n in (arr["rounds"].items() if arr else ()):
            self.H[r] = self.H.get(r, 0) + n
        fired = []
        while self.H.get(self.server_k, 0) >= C:
            del self.H[self.server_k]
            self.server_k += 1
            fired.append(dict(k=self.server_k, at=t + self.lat))
        # each client takes the freshest broadcast due by now
        best_k = self.k.copy()
        for b in self.bcasts:
            if b["at"] <= t:
                best_k = np.maximum(best_k, b["k"])
        take = best_k > self.k
        eta = self.etas[torch.as_tensor(
            np.minimum(self.i, len(self.etas) - 1),
            device=self.dev)].to(self.dtype)
        self.k = best_k
        active = self.i < self.k + self.d
        self.credit += np.where(active, self.accrual, 0)
        s_i = self.sizes[np.minimum(self.i, len(self.sizes) - 1)]
        n = np.where(active, np.minimum(s_i - self.h, self.credit >> FRAC), 0)
        n = np.maximum(n, 0)
        self.credit -= n << FRAC
        h_end = self.h + n
        done = active & (h_end >= s_i)
        ops = self.ops
        ops["ticks"] += 1
        ops["block_ticks"] += int((n > 0).any())
        ops["bucket_applies"] += int(arr is not None)
        ops["cascade_ticks"] += int(bool(fired))
        ops["deliver_ticks"] += int(take.any())
        ops["deliver_rows"] += int(take.sum())
        ops["ring_scatters"] += int(done.any())
        ops["complete_ticks"] += int(done.any())

        # the server applies the due updates; fired broadcasts carry v'
        if arr is not None:
            self.v = self.v - arr["sum"]
        for b in fired:
            b["v"] = self.v
        self.bcasts += fired
        self.broadcasts += len(fired)
        dev = self.dev
        rows = torch.as_tensor(np.flatnonzero(take), device=dev)
        if rows.numel():
            by_k = {b["k"]: b["v"] for b in self.bcasts}
            for kb in np.unique(best_k[take]):
                r = rows[torch.as_tensor(best_k[take] == kb, device=dev)]
                self.w[r] = by_k[int(kb)][None, :] - eta[r, None] * self.U[r]
        if (n > 0).any():
            self.block_fn(self.w, self.U, self.i, self.h, n, eta)
        if done.any():
            r = torch.as_tensor(np.flatnonzero(done), device=dev)
            sent = self.send(r)
            dest = self.pending.setdefault(
                t + self.lat, dict(sum=torch.zeros_like(self.v), rounds={}))
            dest["sum"] = dest["sum"] + self.aggregate(eta[r], sent)
            for rr, cnt in zip(*np.unique(self.i[done], return_counts=True)):
                dest["rounds"][int(rr)] = dest["rounds"].get(int(rr), 0) \
                    + int(cnt)
            self.w[r] = self.w[r] + eta[r, None] * (
                sent - self.U[r])
            self.U[r] = 0.0
            self.messages += int(done.sum())
        self.i = self.i + done
        # a broadcast no client can still take is dropped
        self.bcasts = [b for b in self.bcasts
                       if b["k"] > self.k.min() or b["at"] > t]
        self.h = np.where(done, 0, h_end)
        self.credit = np.where(done, np.minimum(self.credit,
                                                self.block << FRAC),
                               self.credit)

    def send(self, rows: torch.Tensor) -> torch.Tensor:
        """The round updates the finished clients ``rows`` send: their
        U, plus the round's noise under DP."""
        sent = self.U[rows]
        if self.noise_scale > 0.0:
            sent = sent + self.noise_scale * self._noise_rows(rows)
        return sent

    def aggregate(self, eta: torch.Tensor, sent: torch.Tensor):
        """What the finished clients' updates add to the server's step:
        each weighted by its round step size."""
        return (eta[:, None] * sent).sum(0)

    def _noise_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows ``rows`` of the tick's [C, D] standard-normal draw."""
        key = threefry.fold_in(self.noise_key, self.t)
        D = self.D
        out = torch.empty((rows.numel(), D), dtype=torch.float32,
                          device=self.dev)
        lst = rows.tolist()
        # consecutive runs of rows are drawn together
        start = 0
        while start < len(lst):
            end = start
            while end + 1 < len(lst) and lst[end + 1] == lst[end] + 1 \
                    and end + 1 - start < (1 << 24) // D:
                end += 1
            out[start:end + 1] = self.normals(
                key, lst[start] * D, (end + 1 - start) * D,
                self.dev).reshape(-1, D)
            start = end + 1
        return out.to(self.dtype)

    def snapshot(self) -> dict:
        """What the comparison reads: the integers as copies, the floats
        as views of the state (read them before the next tick)."""
        return dict(i=self.i.copy(), h=self.h.copy(), k=self.k.copy(),
                    credit=self.credit.copy(), tick=self.t,
                    server_k=self.server_k, messages=self.messages,
                    broadcasts=self.broadcasts,
                    ops=np.array([self.ops[o] for o in OPS], np.int64),
                    v=self.v, w=self.w, U=self.U)
