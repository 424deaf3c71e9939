"""Client and server state machines — Algorithms 1–4 of the paper (the
reference's ``repro/core/protocol.py``).

Transport-agnostic: the discrete-event simulator
(``repro_torch.core.simulator``) delivers the messages.  Models and
updates are params dicts of tensors (``{"w": [d], "b": []}`` for the
paper's logistic regression) on the simulator's device; the task
(``repro_torch.core.tasks``) does the client compute.

* Server (Algorithm 3): applies U on dequeue (``v ← v − η̄_i U``), tracks
  received (i, c) pairs in H, broadcasts (v, k) once round k is complete
  from all clients, then increments k — as a cascade, since reordered
  delivery can complete several rounds with one message.
* Client (Algorithm 4 + DP lines 17/23/24 of Algorithm 1): s_{i,c} local
  SGD iterations per round accumulating U, optional per-sample clip and
  round Gaussian noise; ISRRECEIVE replaces the local model with
  v̂ − η̄_i · U for fresher global models only.
* Wait gate (Supp. B.2): block while i == k + d.

Only the server's application rule is pluggable (``repro_torch.core.
strategies``): the paper's apply on dequeue, FedAsync's staleness-decayed
mixing, FedBuff's buffered flush.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch import prng
from repro_torch.core.strategies import get_strategy
from repro_torch.tree import leaves, tree_map


@dataclass
class UpdateMsg:
    round_idx: int
    client_id: int
    U: Any                      # params dict: sum of (clipped, noised) grads
    k_send: int = 0             # sender's broadcast counter k at send time


@dataclass
class BroadcastMsg:
    v: Any                      # global model params dict
    k: int                      # completed-round counter


class Server:
    """Algorithm 3."""

    def __init__(self, v0, n_clients: int, round_stepsizes: Sequence[float],
                 strategy=None):
        self.v = v0
        self.n_clients = n_clients
        self.eta_bar = list(round_stepsizes)
        self.k = 0
        self.H: set = set()
        self.processed: List[Tuple[int, int]] = []   # audit log
        self.strategy = get_strategy(strategy)
        self._buf: Optional[Any] = None    # FedBuff accumulator
        self._buf_n = 0                    # updates buffered since flush

    def eta(self, i: int) -> float:
        return self.eta_bar[min(i, len(self.eta_bar) - 1)]

    def receive(self, msg: UpdateMsg) -> List[BroadcastMsg]:
        """Process one queued client update; emit every broadcast now due
        (fire round k, increment k, re-check with the banked (k+1, c)
        pairs, and so on)."""
        eta = self.eta(msg.round_idx)
        strat = self.strategy
        if strat.buffered:
            # FedBuff: bank eta-weighted updates, flush every B arrivals
            contrib = tree_map(lambda u: eta * u, msg.U)
            self._buf = (contrib if self._buf is None
                         else tree_map(lambda b, c: b + c, self._buf,
                                       contrib))
            self._buf_n += 1
            if self._buf_n >= strat.buffer_size:
                self.v = tree_map(lambda v, b: v - b, self.v, self._buf)
                self._buf, self._buf_n = None, 0
        elif strat.stratified:
            # FedAsync: staleness-decayed mixing against the pre-cascade k
            scale = eta * strat.weight(self.k - msg.k_send)
            self.v = tree_map(lambda v, u: v - scale * u, self.v, msg.U)
        else:
            # the paper's Algorithm 3: apply on dequeue, weight 1
            self.v = tree_map(lambda v, u: v - eta * u, self.v, msg.U)
        self.H.add((msg.round_idx, msg.client_id))
        self.processed.append((msg.round_idx, msg.client_id))
        fired: List[BroadcastMsg] = []
        while all((self.k, c) in self.H for c in range(self.n_clients)):
            for c in range(self.n_clients):
                self.H.discard((self.k, c))
            self.k += 1
            fired.append(BroadcastMsg(v=self.v, k=self.k))
        return fired


class Client:
    """Algorithm 4 (+ Algorithm 1's DP lines)."""

    def __init__(self, client_id: int, w0, task, sizes: Sequence[int],
                 round_stepsizes: Sequence[float], d: int, seed: int):
        self.id = client_id
        self.task = task
        self.w = w0
        self.U = task.zero_update(device=leaves(w0)[0].device)
        self.sizes = list(sizes)               # s_{i,c}
        self.eta_bar = list(round_stepsizes)
        self.d = d
        self.i = 0                             # current round
        self.h = 0                             # iterations done in round i
        self.k = 0                             # latest broadcast counter seen
        self.rng = prng.PRNGKey(seed)          # on the CPU
        self.sent_rounds: List[int] = []
        # diagnostics for Theorem 1's invariant t_delay <= tau(t_glob)
        self.delay_trace: List[Tuple[int, int]] = []

    def eta(self, i: int) -> float:
        return self.eta_bar[min(i, len(self.eta_bar) - 1)]

    def s(self, i: int) -> int:
        return self.sizes[min(i, len(self.sizes) - 1)]

    @property
    def blocked(self) -> bool:
        """Wait gate: block while i == k + d (Supp. B.2)."""
        return self.i >= self.k + self.d

    def remaining_in_round(self) -> int:
        return self.s(self.i) - self.h

    def run(self, n_iters: int) -> None:
        """Advance n local SGD iterations (n <= remaining_in_round)."""
        assert not self.blocked and n_iters <= self.remaining_in_round()
        self.rng, sub = prng.split(self.rng)
        self.w, self.U = self.task.run_iterations(
            self.w, self.U, round_idx=self.i, client_id=self.id,
            start_h=self.h, n_iters=n_iters, eta=self.eta(self.i), rng=sub)
        self.h += n_iters

    def finish_round(self) -> UpdateMsg:
        """Round complete: draw DP batch noise, send (i, c, U), advance."""
        assert self.h == self.s(self.i)
        self.rng, sub = prng.split(self.rng)
        self.w, self.U = self.task.add_round_noise(
            self.w, self.U, eta=self.eta(self.i), rng=sub)
        msg = UpdateMsg(round_idx=self.i, client_id=self.id, U=self.U,
                        k_send=self.k)
        self.sent_rounds.append(self.i)
        self.i += 1
        self.h = 0
        self.U = self.task.zero_update(
            device=leaves(self.w)[0].device)
        return msg

    def isr_receive(self, msg: BroadcastMsg) -> None:
        """Algorithm 4 ISRRECEIVE: accept only fresher global models."""
        if msg.k > self.k:
            self.k = msg.k
            eta = self.eta(self.i)
            self.w = tree_map(lambda v, u: v - eta * u, msg.v, self.U)

    def record_delay(self, global_sizes: Sequence[int]) -> Tuple[int, int]:
        """(t_glob, t_delay) at the current iteration (paper lines 12-13)."""
        s = global_sizes
        cum = 0
        for j in range(min(self.i + 1, len(s))):
            cum += s[j]
        t_glob = cum - (self.s(self.i) - self.h) - 1
        t_delay = sum(s[j] for j in range(self.k, min(self.i + 1, len(s)))) \
            - (self.s(self.i) - self.h)
        self.delay_trace.append((t_glob, t_delay))
        return t_glob, t_delay
