"""Biased (label-skewed) client datasets on the PyTorch port: the
paper's Fig 2 regime.

``examples/biased_clients.py`` through ``repro_torch``: client 0 holds
(almost) only positives, client 1 only negatives; the asynchronous
protocol still converges to the global objective.  Runs on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_biased_clients.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import SampleSequenceConfig, StepSizeConfig
from repro_torch.core import (AsyncFLSimulator, LogRegTask, round_stepsizes,
                              rounds_for_budget)
from repro_torch.data import biased_split, make_binary_dataset, unbiased_split


def run(shards, X, y, label, budget, device):
    sizes = rounds_for_budget(
        SampleSequenceConfig(kind="linear", s0=100, a=100.0), budget)
    etas = round_stepsizes(
        StepSizeConfig(kind="inv_t", eta0=0.01, beta=0.001), sizes)
    global_task = LogRegTask(X, y, l2=1.0 / len(X))
    sim = AsyncFLSimulator(
        global_task, n_clients=len(shards),
        sizes_per_client=[[max(1, s // len(shards)) for s in sizes]]
        * len(shards),
        round_stepsizes=etas, d=1, seed=0, device=device)
    for c, (sx, sy) in enumerate(shards):
        sim.clients[c].task = LogRegTask(sx, sy, l2=1.0 / len(sx))
    res = sim.run(max_rounds=len(sizes))
    print(f"[{label:9s}] rounds={res['final']['round']} "
          f"global-test acc={res['final']['accuracy']:.4f}")
    return res["final"]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' here)")
    ap.add_argument("--n", type=int, default=4_000, help="examples")
    ap.add_argument("--budget", type=int, default=6_000,
                    help="total gradient budget of each run")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    X, y = make_binary_dataset(args.n, 16, seed=6, noise=0.3)
    u = run(unbiased_split(X, y, 2, seed=0), X, y, "unbiased", args.budget,
            args.device)
    b = run(biased_split(X, y, 2, bias=1.0, seed=0), X, y, "biased",
            args.budget, args.device)
    a_u, a_b = float(u["accuracy"]), float(b["accuracy"])
    print(f"=> difference {abs(a_u - a_b):.4f}: the protocol tolerates "
          "label-skewed clients (paper Fig 2)")
    return {"rounds": [int(u["round"]), int(b["round"])],
            "messages": [int(u["messages"]), int(b["messages"])],
            "accuracy": [a_u, a_b],
            "loss": [float(u["loss"]), float(b["loss"])]}


if __name__ == "__main__":
    main()
