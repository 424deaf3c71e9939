"""The comparison that decides ``correct``: the program's state after each
of the first ticks of its run and at the window's end, against the plain
protocol stepped from the same inputs.

Every cell compares ``protocol_mismatches``: the integers that differ,
over every tick read: each client's round ``i``, in-round offset ``h``,
freshest model ``k`` and step credit, and the tick, the server's round,
the messages, the broadcasts and the ten counters of the op census.
Exact: limit 0.  Its task adds the floats (``rows_gaps`` or
``leaf_gaps``); each number is the worst over the first ticks, and the
same number of the window's end has a name of its own (``<name>_end``):
round-off grows over a window of tens of ticks, so the two are held to
limits of their own in the configuration's file.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np
import torch

INTS = ("i", "h", "k", "credit")
SCALARS = ("tick", "server_k", "messages", "broadcasts")


def program_ints(engine) -> dict:
    """The program's protocol integers, on the host."""
    st = engine.local_state
    out = {name: getattr(st, name).cpu().numpy().astype(np.int64)
           for name in INTS}
    out.update(zip(SCALARS, torch.stack([st.tick, st.server_k, st.messages,
                                         st.broadcasts]).tolist()))
    out["ops"] = st.ops.cpu().numpy().astype(np.int64)
    return out


def int_mismatches(snap: dict, r: dict) -> int:
    n = sum(int((snap[k] != r[k]).sum()) for k in INTS)
    n += sum(int(snap[k] != r[k]) for k in SCALARS)
    return n + int((snap["ops"] != r["ops"]).sum())


def _row_sq(a: torch.Tensor) -> torch.Tensor:
    return (a.float() * a.float()).sum(-1)


def rows_gaps(snap: dict, r: dict) -> Dict[str, float]:
    """``rows_gap``: the worst client's gap between its row ``[w | U]`` in
    the program and in the reference, as the norm of the difference over
    the reference row's norm or the median row's norm, whichever is
    larger (a row just reset to zero has no scale of its own).
    ``server_gap``: the norm of the server model's difference over its
    norm in the reference."""
    dev = r["w"].device
    d_sq = torch.zeros(r["w"].shape[0], device=dev)
    ref_sq = torch.zeros_like(d_sq)
    for name in ("w", "U"):
        d_sq += _row_sq(snap[name].to(dev) - r[name].float())
        ref_sq += _row_sq(r[name])
    ref_n = ref_sq.sqrt()
    scale = torch.clamp(ref_n, min=max(float(ref_n.median()), 1e-30))
    v_ref = r["v"].float()
    dv = float((snap["v"].to(dev) - v_ref).norm())
    return {"rows_gap": float((d_sq.sqrt() / scale).max()),
            "server_gap": dv / max(float(v_ref.norm()), 1e-30)}


def leaf_norms(vec: torch.Tensor, base, spans) -> torch.Tensor:
    """The norm of ``vec - base`` (``base`` None: of ``vec``) over each
    leaf ``(name, offset, size)``, in f64 on the host."""
    out = []
    for _, o, n in spans:
        x = vec[o:o + n].float()
        if base is not None:
            x = x - base[o:o + n].float()
        out.append(x.double().norm())
    return torch.stack(out).cpu()


def leaf_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst leaf's gap between two rows of leaf norms: the
    difference over the reference's norm of that leaf or of the median
    leaf, whichever is larger; 0 where both are 0."""
    scale = torch.clamp(want, min=float(want.median()))
    gap = (got - want).abs() / torch.clamp(scale, min=1e-300)
    gap = torch.where((got == 0) & (want == 0), 0.0, gap)
    return float(gap.max())


def worst(values) -> float:
    """The largest of ``values`` (0 if none), NaN if any is NaN."""
    out = 0.0
    for v in values:
        if math.isnan(v):
            return v
        out = max(out, v)
    return out


def compare(snaps: Iterable[dict], ref, float_gaps) -> dict:
    """Step ``ref`` to the tick of each program snapshot in turn;
    ``float_gaps(snap, ref_snapshot)`` gives the task's float numbers of
    a tick.  Returns every number, the worst tick's; a snapshot marked
    ``window_end`` gives the ``_end`` numbers."""
    out: Dict[str, float] = {"protocol_mismatches": 0}
    for snap in snaps:
        ref.step()
        while ref.t < snap["tick"]:
            ref.step()
        r = ref.snapshot()
        out["protocol_mismatches"] += int_mismatches(snap, r)
        end = "_end" if snap.get("window_end") else ""
        for name, v in float_gaps(snap, r).items():
            out[name + end] = worst([out.get(name + end, 0.0), v])
    return out


def judge(numbers: dict, limits: dict) -> List[str]:
    """The names of the numbers above their limits (a NaN fails)."""
    return [name for name, value in numbers.items()
            if not value <= limits[name]]
