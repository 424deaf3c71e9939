"""Structural checks of the device engine's state (rule family STRUCT-*).

  STRUCT-DTYPE   dtype discipline over a constructed state: every tensor
                 field must be int32 (counters/rings/census — the device
                 engine's whole protocol state is int32, the reference's
                 layout) or float32 (model/accumulator blocks); any other
                 dtype (int64, float64, bool, ...) silently breaks
                 host<->device and port<->reference bit parity

The check introspects a real (tiny) engine state rather than a
hand-maintained mirror list, so it cannot drift from the code it
audits.  The reference's STRUCT-PSPEC / STRUCT-STALE rules check the
state against its sharding specs; the port has none yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from repro_torch.analysis.base import Violation

_WHERE = "repro_torch.cohort.state.DeviceCohortState"


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
    """Run the dtype check against the live engine on ``device``."""
    return check_state_dtypes(_tiny_device_state(device))
