"""End-to-end FL training driver.

The port's copy of ``repro.launch.train``: runs the paper's asynchronous
FL protocol (the event simulator) over any registered architecture —
increasing sample-size rounds, diminishing round step sizes, optional
DP, checkpointing — on the card; ``--device cpu`` runs it on the CPU.
Without ``--reduced`` the model has its full width and depth.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --reduced --rounds 20 --batch 8 --seq 128 [--dp] [--p 1.0]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.checkpoint import save_fl_state
from repro_torch.configs import StepSizeConfig, get_config, reduced
from repro_torch.core import AsyncFLSimulator, BatchModelTask, round_stepsizes
from repro_torch.data import FederatedBatcher
from repro_torch.devices import resolve_device
from repro_torch.models import init_params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="2-layer smoke variant (CPU-friendly)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eta0", type=float, default=0.05)
    ap.add_argument("--p", type=float, default=1.0,
                    help="sample-size growth exponent (0 => constant)")
    ap.add_argument("--s0", type=int, default=1,
                    help="local batch-steps in round 0")
    ap.add_argument("--d", type=int, default=1, help="delay gate slack")
    ap.add_argument("--dp", action="store_true")
    ap.add_argument("--sigma", type=float, default=8.0)
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu runs on the CPU; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.arch_id} family={cfg.family} layers={cfg.n_layers} "
          f"d={cfg.d_model} params~{cfg.param_count()/1e6:.1f}M "
          f"device={dev}")

    sizes = [max(1, int(round(args.s0 * ((i + 2) / 2) ** args.p)))
             for i in range(args.rounds)] if args.p > 0 \
        else [args.s0] * args.rounds
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_sqrt", eta0=args.eta0, beta=0.01), sizes)

    params = init_params(cfg, prng.PRNGKey(args.seed), torch.float32,
                         device=dev)
    batcher = FederatedBatcher(cfg, batch_size=args.batch, seq_len=args.seq,
                               seed=args.seed, device=dev)
    task = BatchModelTask(cfg, params, batcher,
                          dp_clip=args.clip if args.dp else 0.0,
                          dp_sigma=args.sigma if args.dp else 0.0)

    per_client = [sizes] * args.clients   # p_c uniform
    sim = AsyncFLSimulator(
        task, n_clients=args.clients, sizes_per_client=per_client,
        round_stepsizes=etas, d=args.d, seed=args.seed,
        speeds=list(1.0 + 0.1 * np.arange(args.clients)), device=dev)

    t0 = time.time()
    res = sim.run(max_rounds=args.rounds)
    dt = time.time() - t0
    print(f"rounds={res['final']['round']} messages="
          f"{res['final']['messages']} loss={res['final'].get('loss')} "
          f"wall={dt:.1f}s")
    for h in res["history"]:
        print(f"  round {h['round']:3d} loss={h.get('loss')}")
    if args.checkpoint:
        save_fl_state(args.checkpoint, global_model=res["model"],
                      server_k=res["final"]["round"])
        print(f"checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
