"""Small sizes of the benchmark's cells for CPU tests: the same code
paths as the cells, at sizes a test run holds."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

LOGREG = {"traffic": {"clients": 12, "sizes": {
    "kind": "power", "N_c": 10000, "q": 0.00013216327772100012,
    "m": 12.106237281566509, "p": 1.0, "rounds": 40}},
    "config": {"n_examples": 300, "d_features": 24}}
MAMBA2 = {"config": {"n_layers": 2, "d_model": 32, "vocab_size": 300,
                     "ssm_state": 8, "ssm_head_dim": 8, "ssm_chunk": 8,
                     "model": {"batch_rows": 2, "seq_len": 12,
                               "remat": False}}}


def run(workload, overrides, seed=7, seconds=0.2, trace=False, **kw):
    import time
    from fedbench import harness
    return harness.run_cell(workload, seed, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=overrides, **kw)
