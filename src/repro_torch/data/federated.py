"""Federated data layer: client-sharded batch production.

The port's copy of ``repro.data.federated``.  Implements SETUP's
coin-flipping assignment (Algorithm 2 lines 5-13): round i's s_i global
samples are assigned to clients with probabilities p_c, giving s_{i,c}
with E[s_{i,c}] = p_c s_i.  The batchers hand out token batches as torch
tensors on their device (the card unless the caller asks for the CPU),
bit for bit the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.synthetic import make_batch
from repro_torch.devices import resolve_device


def client_sample_sizes(sizes: Sequence[int], p: Sequence[float], *,
                        seed: int = 0, exact: bool = False
                        ) -> List[List[int]]:
    """s_{i,c} per client.  exact=True uses s_{i,c} = round(p_c s_i)
    (the law-of-large-numbers approximation §A uses for the DP theory);
    exact=False flips coins per Algorithm 2."""
    n = len(p)
    rng = np.random.default_rng(seed)
    out: List[List[int]] = [[] for _ in range(n)]
    for s in sizes:
        if exact:
            counts = [max(1, int(round(pc * s))) for pc in p]
        else:
            assign = rng.choice(n, size=s, p=np.asarray(p) / np.sum(p))
            counts = [max(1, int(np.sum(assign == c))) for c in range(n)]
        for c in range(n):
            out[c].append(counts[c])
    return out


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32, as jax's int32 arithmetic wraps."""
    return ((x + 2 ** 31) & prng.MASK32) - 2 ** 31


class SeedAddressedBatcher:
    """(client, round, iteration)-addressed LM batches.

    One key per (client, round, iteration) from the ``fold_in`` chain
    ``fold_in(fold_in(fold_in(PRNGKey(seed), client), round), h)``, and
    the batch from that key alone (``batch_from_key``), so the event
    simulator (calling this object as ``data_fn``) and the cohort
    engines (calling ``batch_from_key`` inside their blocks) draw the
    same batch for the same address, however either engine chunks a
    round.  ``batch_from_key`` takes a key on any device and makes no
    host round trip.  The token process mirrors ``TokenStream``
    (orderly Markov-ish sequences + 5% noise), so training loss
    decreases on it.
    """

    def __init__(self, cfg, *, batch_size: int, seq_len: int, seed: int = 0,
                 device=None):
        if cfg.family == "encdec":
            raise ValueError(
                "SeedAddressedBatcher supports decoder families only: the "
                "encdec encoder-embedding stub is host-side numpy (use "
                "FederatedBatcher with the event engine)")
        self.cfg = cfg
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.base = prng.PRNGKey(self.seed)                 # on the CPU

    def key_for(self, client_id, round_idx: int, h: int) -> torch.Tensor:
        k = prng.fold_in(self.base, client_id)
        k = prng.fold_in(k, round_idx)
        return prng.fold_in(k, h)

    def batch_from_key(self, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        """key [2] -> {"tokens": (B, S) int32} on the batcher's device."""
        V, B, S = self.cfg.vocab_size, self.batch_size, self.seq_len
        dev = self.device
        ka, kb, ks, km, kn = prng.split_batch(key.to(dev)[None], 5)[0]
        a = 2 * prng.randint(ka, (B, 1), 1, 8) + 1
        b = prng.randint(kb, (B, 1), 0, V)
        start = prng.randint(ks, (B, 1), 0, V)
        t = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
        toks = _i32(_i32(start + _i32(a * t)) + _i32(b * (t // 7)))
        toks = torch.remainder(toks, V)
        noise_mask = prng.keys_uniform(km[None], (B, S))[0] < 0.05
        noise = prng.randint(kn, (B, S), 0, V)
        return {"tokens": torch.where(noise_mask, noise, toks).to(
            torch.int32)}

    def __call__(self, client_id: int, round_idx: int, h: int, rng=None):
        # rng accepted (and ignored) for the data_fn signature: addressing
        # is purely (client, round, iteration)
        return self.batch_from_key(self.key_for(client_id, round_idx, h))


class FederatedBatcher:
    """Per-client LM batch producer for BatchModelTask / fl_step (host
    numpy, ``make_batch``), handed out on the batcher's device."""

    def __init__(self, cfg, *, batch_size: int, seq_len: int, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.device = resolve_device(device)

    def __call__(self, client_id: int, round_idx: int, h: int, rng=None):
        step = round_idx * 10_000 + h
        batch = make_batch(self.cfg, self.batch_size, self.seq_len,
                           seed=self.seed, step=step, client_id=client_id)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def global_batch(self, n_clients: int, round_idx: int):
        """(C, B, S) stacked batch for ``fl_step``'s train step."""
        parts = [self(c, round_idx, 0) for c in range(n_clients)]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
