"""Structural checks of the device engine's state (rule family STRUCT-*).

  STRUCT-PSPEC   a ``DeviceCohortState`` field has no partition spec in
                 ``repro_torch.sharding.cohort_pspecs``
  STRUCT-STALE   ``cohort_pspecs`` carries a spec for a field that no
                 longer exists (dead spec — usually a rename half done)
  STRUCT-DTYPE   dtype discipline over a constructed state: every tensor
                 field must be int32 (counters/rings/census — the device
                 engine's whole protocol state is int32, the reference's
                 layout) or float32 (model/accumulator blocks); any other
                 dtype (int64, float64, bool, ...) silently breaks
                 host<->device and port<->reference bit parity

The checks introspect the real NamedTuple and a real (tiny) engine
state rather than a hand-maintained mirror list, so they cannot drift
from the code they audit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import torch

from repro_torch.analysis.base import Violation

_WHERE = "repro_torch.cohort.state.DeviceCohortState"


def check_state_coverage(fields: Sequence[str],
                         pspecs: Mapping[str, Any],
                         where: str = _WHERE) -> List[Violation]:
    """Pure core: every state field has a spec, every spec has a field."""
    out: List[Violation] = []
    for f in fields:
        if f not in pspecs:
            out.append(Violation(
                "STRUCT-PSPEC", where, 0,
                f"state field {f!r} has no partition spec in "
                f"repro_torch.sharding.cohort_pspecs — the [C, ...] block "
                f"would silently replicate (or fail) on a sharded mesh; "
                f"add it to sharding/specs.py"))
    for f in pspecs:
        if f not in fields:
            out.append(Violation(
                "STRUCT-STALE", where, 0,
                f"cohort_pspecs declares a spec for {f!r}, which is not "
                f"a state field — remove the dead spec"))
    return out


def check_state_dtypes(state_fields: Mapping[str, torch.Tensor],
                       where: str = _WHERE) -> List[Violation]:
    """Pure core: int32/float32 discipline over realized tensor fields."""
    out: List[Violation] = []
    for name, leaf in state_fields.items():
        dt = leaf.dtype
        if dt.is_floating_point:
            if dt != torch.float32:
                out.append(Violation(
                    "STRUCT-DTYPE", where, 0,
                    f"field {name!r} is {dt}, want float32 — a wider or "
                    f"narrower accumulator diverges from the reference's "
                    f"f32 path and breaks bit parity"))
        elif dt.is_complex or dt == torch.bool:
            out.append(Violation(
                "STRUCT-DTYPE", where, 0,
                f"field {name!r} has non-numeric dtype {dt}"))
        elif dt != torch.int32:
            out.append(Violation(
                "STRUCT-DTYPE", where, 0,
                f"field {name!r} is {dt}, want int32 — the reference "
                f"carries every counter as i32; a widened counter "
                f"changes wraparound/census semantics"))
    return out


def _tiny_device_state(device=None) -> Dict[str, Any]:
    """A real (small) DeviceCohortState, as the engine constructs it on
    ``device`` (the card when omitted)."""
    from repro_torch.cohort.device import DeviceCohortEngine
    from repro_torch.cohort.simulator import as_cohort_task
    from repro_torch.core.tasks import LogRegTask
    from repro_torch.data import make_binary_dataset

    X, y = make_binary_dataset(24, 4, seed=0, noise=0.3)
    task = LogRegTask(X, y, l2=0.1, sample_seed=1)
    eng = DeviceCohortEngine(as_cohort_task(task, 4, device=device),
                             sizes_per_client=[2],
                             round_stepsizes=[0.1], d=1, seed=0)
    return eng.state._asdict()


def check_cohort_structure(device=None) -> List[Violation]:
    """Run the coverage check against the live state type and specs, and
    the dtype check against the live engine on ``device``."""
    from repro_torch.cohort.state import DeviceCohortState
    from repro_torch.sharding import MeshShape, cohort_pspecs

    # the rules read the mesh's axis names and sizes only: eight ranks
    pspecs = cohort_pspecs(MeshShape(("clients",), (8,)), 8)
    out = check_state_coverage(DeviceCohortState._fields, pspecs)
    if not out:   # dtype pass needs a constructible state
        out.extend(check_state_dtypes(_tiny_device_state(device)))
    return out
