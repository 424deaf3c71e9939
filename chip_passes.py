#!/usr/bin/env python3
"""Per-pass device times of ``tick_scatter`` and ``clip_accumulate`` for
one checkout, on one NVIDIA GPU.

    python3 chip_passes.py [TREE] [LABEL]

Imports ``repro_torch`` from TREE/src (default: this checkout), builds
its ``tick_fused`` and ``dp_clip`` libraries and prints their ptxas
reports (registers, spills), then times each wrapper at the shapes of
the paths that run it: ``tick_scatter`` at C = 16384, D = 785 with
half the rows done, at G = 2 ring rows (the main run, FedBuff) and G =
8 (FedAsync's L * R); ``clip_accumulate`` at the DP round's (60000,
785) in f32 and bf16 and its microbatch (6000, 785) in f32.  Each case
prints one ``passes LABEL ...`` line: the whole call (median of CUDA
graph replays), each kernel the call launches (``torch.profiler``), and
the bound.  To compare two commits, unpack the other one into a
directory that ``.gitignore`` lists and run both in one call, in turns
(parent, change, change, parent); each run is its own process.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SCATTER = dict(C=16_384, D=785, done_share=0.5)
CLIP = ((60_000, 785, "float32"), (60_000, 785, "bfloat16"),
        (6_000, 785, "float32"))


def scatter_inputs(dev, G: int):
    """sent, w, U, upd, wgt, any_g, done, eta at SCATTER's shape: G = 2
    scatters the done rows into ring row 0 (row 1 stays empty), G > 2
    into G - 1 rows by a random (slot, stratum), the last row empty."""
    import torch
    C, D = SCATTER["C"], SCATTER["D"]
    g = torch.Generator(device=dev).manual_seed(G)
    sent, w, U = (torch.randn((C, D), generator=g, device=dev)
                  for _ in range(3))
    upd = torch.randn((G, D), generator=g, device=dev)
    done = torch.rand(C, generator=g, device=dev) < SCATTER["done_share"]
    eta = 0.1 * torch.rand(C, generator=g, device=dev)
    pick = torch.randint(0, G - 1, (C,), generator=g, device=dev)
    masks = torch.stack([done & (pick == r) for r in range(G)])
    wgt = eta[None, :] * masks.float()
    return sent, w, U, upd, wgt, masks.any(1), done, eta


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    label = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_passes: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.kernels.dp_clip import clip_accumulate
    from repro_torch.kernels.tick_fused import tick_scatter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"passes {label}: {smi} tree={root}")
    logs = _build.build_all(["tick_fused", "dp_clip"])
    for name in ("tick_fused", "dp_clip"):
        lines = [ln.strip() for ln in logs.get(name, "").splitlines()
                 if "entry function" in ln or "Used" in ln or "spill" in ln]
        for line in lines or ["(library cached: no ptxas report)"]:
            print(f"passes {label} ptxas {name}: {line}")
    dev = torch.device("cuda")
    rows = []
    for G in (2, 8):
        args = scatter_inputs(dev, G)
        nd = int(args[6].sum())

        def call():
            return tick_scatter(*args, dp_on=True)
        bms, by = cs.scatter_bound(SCATTER["C"], SCATTER["D"], G, nd)
        rows.append(dict(kernel="tick_scatter", C=SCATTER["C"],
                         D=SCATTER["D"], G=G, done=nd,
                         ms=cs.median_ms(call), passes_ms=cs.kernel_ms(call),
                         bound_ms=bms, bound_by=by))
        del args
    for N, D, dt in CLIP:
        g = torch.Generator(device=dev).manual_seed(N)
        Gm = (3.0 * torch.randn((N, D), generator=g, device=dev)).to(
            getattr(torch, dt))

        def call():
            return clip_accumulate(Gm, clip=0.1)
        bms, by = cs.clip_bound(N, D, Gm.element_size())
        rows.append(dict(kernel="clip_accumulate", N=N, D=D, dtype=dt,
                         ms=cs.median_ms(call), passes_ms=cs.kernel_ms(call),
                         bound_ms=bms, bound_by=by))
        del Gm
    for r in rows:
        print(f"passes {label} " + " ".join(f"{k}={v}" for k, v in r.items()))
    print(json.dumps({"passes": label, "device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
