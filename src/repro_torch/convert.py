"""Carry weights and state across from numpy copies of the reference's.

The port never imports the reference; a caller that has both hands over
numpy arrays (``np.asarray`` of each leaf / field).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.cohort.state import DeviceCohortState

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected dtype {a.dtype} (want float32 or "
                        f"int32, as the reference keeps them)")
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=device)


def params_from_jax(params: Mapping[str, Any],
                    device=None) -> Dict[str, torch.Tensor]:
    """``{"w": [d], "b": []}`` numpy logreg params -> the port's."""
    return {"w": _tensor(params["w"], device), "b": _tensor(params["b"],
                                                            device)}


def state_from_jax(np_state, device=None) -> DeviceCohortState:
    """A numpy copy of the reference's ``DeviceCohortState`` (a NamedTuple
    or a mapping of its fields) -> the port's, field by field."""
    fields = (np_state._asdict() if hasattr(np_state, "_asdict")
              else dict(np_state))
    missing = set(DeviceCohortState._fields) - set(fields)
    if missing:
        raise ValueError(f"state lacks fields {sorted(missing)}")
    return DeviceCohortState(**{f: _tensor(fields[f], device)
                                for f in DeviceCohortState._fields})

