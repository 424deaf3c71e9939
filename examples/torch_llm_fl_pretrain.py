"""End-to-end driver on the PyTorch port: asynchronous FL pre-training of
a reduced gemma-family decoder.

``examples/llm_fl_pretrain.py`` through ``repro_torch``: a reduced
4-layer decoder (the production configs' code path) trained through the
full async protocol for a few dozen local steps with round-growing
sample sizes.  ``--engine cohort|device`` runs the same task through the
cohort engines via the flat-params adapter (``repro_torch.cohort.flat``).
Batches are seed-addressed ((client, round, iteration) via ``fold_in``),
so all engines follow the same data order.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/torch_llm_fl_pretrain.py [--rounds 8]
    PYTHONPATH=src python examples/torch_llm_fl_pretrain.py --engine device
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import prng
from repro_torch.cohort import make_simulator
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import StepSizeConfig
from repro_torch.core import BatchModelTask, round_stepsizes
from repro_torch.data import SeedAddressedBatcher
from repro_torch.devices import resolve_device
from repro_torch.models import init_params, train_loss


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--engine", default="event",
                    choices=["event", "cohort", "device"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' here)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), n_layers=args.layers,
                  d_model=args.d_model, vocab=2048)
    n_params = cfg.param_count()
    print(f"{cfg.arch_id} reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"~{n_params/1e6:.1f}M params")

    params = init_params(cfg, prng.PRNGKey(0), torch.float32, device=dev)
    batcher = SeedAddressedBatcher(cfg, batch_size=args.batch,
                                   seq_len=args.seq, seed=0, device=dev)
    task = BatchModelTask(cfg, params, batcher)

    # growing rounds: 1, 2, 3, ... local batch-steps per round
    sizes = [[1 + i for i in range(args.rounds)]] * args.clients
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_sqrt", eta0=0.1, beta=0.05),
        sizes[0])

    with torch.no_grad():
        loss0 = float(train_loss(cfg, params, batcher(0, 0, 0)))
    t0 = time.time()
    sim = make_simulator(args.engine, task, n_clients=args.clients,
                         sizes_per_client=sizes,
                         round_stepsizes=etas, d=1, seed=0,
                         speeds=[1.0 + 0.2 * c
                                 for c in range(args.clients)],
                         device=dev)
    res = sim.run(max_rounds=args.rounds)
    with torch.no_grad():
        loss1 = float(train_loss(cfg, res["model"], batcher(0, 0, 0)))
    steps = sum(sizes[0]) * args.clients
    print(f"async FL [{args.engine}]: "
          f"{res['final']['round']} rounds, {steps} local steps, "
          f"{res['final']['messages']} messages, "
          f"wall {time.time()-t0:.1f}s")
    print(f"eval loss {loss0:.3f} -> {loss1:.3f}")
    assert loss1 < loss0, "loss should decrease"
    return {"n_params": int(n_params), "rounds": int(res["final"]["round"]),
            "steps": int(steps), "messages": int(res["final"]["messages"]),
            "loss0": loss0, "loss1": loss1}


if __name__ == "__main__":
    main()
