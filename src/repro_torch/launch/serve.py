"""Batched serving driver: prefill + decode loop with KV/SSM caches.

The port's copy of ``repro.launch.serve``: serves a (reduced) model on
the card — builds the decode cache, prefills a prompt batch, then decodes
tokens greedily with ``serve_step``.  ``--device cpu`` runs it on the
CPU (the plain versions); by default it runs on the card and fails
without one.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --reduced --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import prng
from repro_torch.configs import get_config, reduced
from repro_torch.data import make_batch
from repro_torch.devices import resolve_device
from repro_torch.models import encdec, init_cache, init_params, serve_step


def prefill_into_cache(cfg, params, cache, tokens, *, seq_len):
    """Sequential prefill via serve_step (correct for every family)."""
    logits = None
    for pos in range(tokens.shape[1]):
        logits, cache = serve_step(cfg, params, cache, tokens[:, pos:pos + 1],
                                   pos, seq_len=seq_len)
    return logits, cache


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the CPU "
                         "(default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    seq_len = args.prompt_len + args.gen
    params = init_params(cfg, prng.PRNGKey(args.seed), torch.float32,
                         device=dev)
    cache = init_cache(cfg, args.batch, seq_len, torch.float32, device=dev)

    batch = make_batch(cfg, args.batch, args.prompt_len, seed=args.seed)
    tokens = torch.as_tensor(batch["tokens"], device=dev)

    with torch.no_grad():
        if cfg.family == "encdec":
            enc_out = encdec.encode(
                cfg, params, torch.as_tensor(batch["encoder_embeds"],
                                             device=dev))
            cache = encdec.prime_cross_cache(cfg, params, cache, enc_out)

        t0 = time.time()
        logits, cache = prefill_into_cache(cfg, params, cache, tokens,
                                           seq_len=seq_len)
        _sync(dev)
        print(f"prefill {args.prompt_len} tokens x{args.batch}: "
              f"{time.time()-t0:.2f}s")

        out = []
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        t0 = time.time()
        for i in range(args.gen):
            logits, cache = serve_step(cfg, params, cache, cur,
                                       args.prompt_len + i, seq_len=seq_len)
            cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(cur)
        _sync(dev)
        dt = time.time() - t0
    gen = torch.cat(out, dim=1)
    print(f"decoded {args.gen} tokens x{args.batch} in {dt:.2f}s "
          f"({args.gen*args.batch/dt:.1f} tok/s) on {dev}")
    print("sample:", gen[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
