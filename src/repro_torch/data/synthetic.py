"""Synthetic LM token pipeline (deterministic, seedable, shardable).

The port's copy of ``repro.data.synthetic`` (numpy, bit for bit the
reference's): next-token-predictable streams (orderly Markov-ish
sequences so a training run shows decreasing loss) for smoke tests, the
serve driver and ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenStream:
    """Deterministic pseudo-corpus: y_{t+1} = (a*y_t + b + drift) % V."""

    def __init__(self, vocab_size: int, *, seed: int = 0):
        self.V = vocab_size
        self.seed = seed

    def batch(self, batch_size: int, seq_len: int, *, step: int = 0,
              client_id: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + client_id * 7919 + step) % (2 ** 63))
        a = 2 * rng.integers(1, 8, size=(batch_size, 1)) + 1
        b = rng.integers(0, self.V, size=(batch_size, 1))
        start = rng.integers(0, self.V, size=(batch_size, 1))
        t = np.arange(seq_len)[None, :]
        toks = (start + a * t + b * (t // 7)) % self.V
        # inject noise tokens to keep the task non-trivial
        noise_mask = rng.random((batch_size, seq_len)) < 0.05
        noise = rng.integers(0, self.V, size=(batch_size, seq_len))
        toks = np.where(noise_mask, noise, toks)
        return {"tokens": toks.astype(np.int32)}


def encoder_embed_stub(batch_size: int, enc_seq: int, d_model: int, *,
                       seed: int = 0, step: int = 0) -> np.ndarray:
    """Precomputed frame/patch embeddings — the modality-frontend stub."""
    rng = np.random.default_rng(seed * 65_537 + step)
    return (0.02 * rng.standard_normal(
        (batch_size, enc_seq, d_model))).astype(np.float32)


def make_batch(cfg, batch_size: int, seq_len: int, *, seed: int = 0,
               step: int = 0, client_id: int = 0) -> Dict[str, np.ndarray]:
    """Family-aware batch: adds the encoder stub for enc-dec archs."""
    stream = TokenStream(cfg.vocab_size, seed=seed)
    batch = stream.batch(batch_size, seq_len, step=step, client_id=client_id)
    if cfg.family == "encdec":
        batch["encoder_embeds"] = encoder_embed_stub(
            batch_size, cfg.encoder_seq_len, cfg.d_model,
            seed=seed, step=step)
    return batch
