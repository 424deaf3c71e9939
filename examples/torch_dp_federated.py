"""Differentially-private asynchronous FL on the PyTorch port,
parameterized by Theorem 4.

``examples/dp_federated.py`` through ``repro_torch``: the paper's
parameter-selection procedure (Supp. D.3.2, Example 3) derives the
sample-size sequence, round count and privacy budget from (s0, N_c, p,
epsilon, sigma); then training with gradient clipping and per-round
Gaussian noise.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_dp_federated.py [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import StepSizeConfig
from repro_torch.core import AsyncFLSimulator, LogRegTask, round_stepsizes
from repro_torch.data import make_binary_dataset
from repro_torch.dp import select_parameters


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' here)")
    ap.add_argument("--n", type=int, default=4_000, help="examples")
    ap.add_argument("--max-rounds", type=int, default=150,
                    help="most rounds trained")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    # 1. privacy planning with the Theorem-4 accountant
    sel = select_parameters(s0c=16, N_c=10_000, p=1.0, epsilon=1.0,
                            sigma=8.0, K=25_000, r0=1.0 / math.e)
    print("accountant:", sel.summary())
    print(f"  per-round noise sigma={sel.sigma}, rounds T={sel.T}")
    print(f"  vs constant-size FL: {sel.T_constant} rounds, aggregated "
          f"noise {sel.aggregated_noise_constant:.0f} -> "
          f"{sel.aggregated_noise:.0f}")

    # 2. train with exactly those parameters
    X, y = make_binary_dataset(args.n, 16, seed=2, noise=0.3)
    n_clients = 5
    task = LogRegTask(X, y, l2=1.0 / len(X), dp_clip=0.1,
                      dp_sigma=sel.sigma)
    sizes = sel.sizes
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_t", eta0=0.15, beta=0.001), sizes)
    sim = AsyncFLSimulator(
        task, n_clients=n_clients,
        sizes_per_client=[[max(1, s // n_clients) for s in sizes]]
        * n_clients,
        round_stepsizes=etas, d=1, seed=0, device=args.device)
    res = sim.run(max_rounds=min(len(sizes), args.max_rounds))
    print(f"DP training: rounds={res['final']['round']} "
          f"acc={res['final']['accuracy']:.4f} "
          f"(eps={sel.epsilon}, delta={sel.delta:.2e})")
    return {"sigma": float(sel.sigma), "T": int(sel.T),
            "T_constant": int(sel.T_constant),
            "epsilon": float(sel.epsilon), "delta": float(sel.delta),
            "aggregated_noise": float(sel.aggregated_noise),
            "rounds": int(res["final"]["round"]),
            "messages": int(res["final"]["messages"]),
            "accuracy": float(res["final"]["accuracy"]),
            "loss": float(res["final"]["loss"])}


if __name__ == "__main__":
    main()
