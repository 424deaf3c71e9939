"""Quickstart on the PyTorch port: asynchronous FL on a strongly-convex
problem, the paper's core recipe (increasing sample sizes + diminishing
round step sizes) against original (constant/constant) FL.

``examples/quickstart.py`` through ``repro_torch``: the same sizes,
seeds and printed lines.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import SampleSequenceConfig, StepSizeConfig
from repro_torch.core import (AsyncFLSimulator, LogRegTask, round_stepsizes,
                              rounds_for_budget, run_sync_baseline)
from repro_torch.data import make_binary_dataset


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' here)")
    ap.add_argument("--n", type=int, default=4_000, help="examples")
    ap.add_argument("--d", type=int, default=32, help="features")
    ap.add_argument("--budget", type=int, default=8_000,
                    help="total gradient budget K")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    # 1. data + strongly-convex objective (logistic regression + L2)
    X, y = make_binary_dataset(n=args.n, d=args.d, seed=0, noise=0.3)
    task = LogRegTask(X, y, l2=1.0 / len(X))
    K = args.budget                # total gradient budget
    n_clients = 5

    # 2. the paper's recipe: s_i = 100 + 100 i,  eta_i = 0.1 / (1 + 0.001 t)
    sizes = rounds_for_budget(
        SampleSequenceConfig(kind="linear", s0=100, a=100.0), K)
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_t", eta0=0.1, beta=0.001), sizes)

    # 3. run the asynchronous protocol (event-driven network simulator)
    sim = AsyncFLSimulator(
        task, n_clients=n_clients,
        sizes_per_client=[[max(1, s // n_clients) for s in sizes]]
        * n_clients,
        round_stepsizes=etas, d=1, seed=0,
        speeds=[1.0, 0.8, 1.2, 0.9, 1.1],    # heterogeneous clients
        device=args.device)
    res = sim.run(max_rounds=len(sizes))
    print(f"[async, increasing]  rounds={res['final']['round']:3d} "
          f"acc={res['final']['accuracy']:.4f} "
          f"messages={res['final']['messages']}")

    # 4. original FL baseline: constant step + constant sample size
    const = run_sync_baseline(task, n_clients=n_clients,
                              n_rounds=K // 400,
                              sample_size=400 // n_clients, eta=0.0025,
                              device=args.device)
    print(f"[sync,  constant]    rounds={const['final']['round']:3d} "
          f"acc={const['final']['accuracy']:.4f}")
    print("=> same-or-better accuracy in far fewer communication rounds "
          "(paper Fig 1a)")
    return {"rounds": int(res["final"]["round"]),
            "messages": int(res["final"]["messages"]),
            "accuracy": float(res["final"]["accuracy"]),
            "loss": float(res["final"]["loss"]),
            "sync_rounds": int(const["final"]["round"]),
            "sync_accuracy": float(const["final"]["accuracy"]),
            "sync_loss": float(const["final"]["loss"])}


if __name__ == "__main__":
    main()
