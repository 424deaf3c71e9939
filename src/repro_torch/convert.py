"""Carry weights and state across from numpy copies of the reference's.

The port never imports the reference; a caller that has both hands over
numpy arrays (``np.asarray`` of each leaf / field).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cohort.state import (BroadcastRing, CohortState,
                                      DeviceCohortState, UpdateBuckets)
# layer i of a stacked (L, ...) params tree, for the callers of convert
from repro_torch.models.transformer import layer  # noqa: F401

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int8): torch.int8}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # jax's bfloat16 (an ml_dtypes type, known here by its name): every
        # value is exact in f32 and back in torch.bfloat16
        return torch.tensor(a.astype(np.float32),
                            device=device).to(torch.bfloat16)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected dtype {a.dtype} (want float32, "
                        f"bfloat16, int32 or int8, as the reference keeps "
                        f"them)")
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=device)


def params_from_jax(params: Mapping[str, Any],
                    device=None) -> Dict[str, torch.Tensor]:
    """``{"w": [d], "b": []}`` numpy logreg params -> the port's."""
    return {"w": _tensor(params["w"], device), "b": _tensor(params["b"],
                                                            device)}


def stacked_params_from_jax(params: Mapping[str, Any],
                            device=None) -> Dict[str, torch.Tensor]:
    """Numpy copies of a layer stack's params (``init_attention`` /
    ``init_ssm``: every leaf stacked ``(L, ...)``) -> the port's."""
    out = {k: _tensor(v, device) for k, v in params.items()}
    depths = {t.shape[0] for t in out.values()}
    if len(depths) != 1:
        raise ValueError(f"leaves stack different depths {sorted(depths)}")
    return out


def _tree(np_tree, device, what: str, dtypes):
    if isinstance(np_tree, Mapping):
        return {k: _tree(v, device, f"{what}/{k}", dtypes)
                for k, v in np_tree.items()}
    a = np.asarray(np_tree)
    if a.dtype.name not in dtypes:
        raise TypeError(f"{what}: dtype {a.dtype.name}, want one of "
                        f"{dtypes}")
    return _tensor(a, device)


def model_params_from_jax(np_tree: Mapping[str, Any], device=None):
    """Numpy copies of a whole decoder or encdec params tree (the
    reference's ``models.init_params``; f32 or bf16 leaves, by dtype
    name) -> the port's nested dict of tensors, in the same layout."""
    return _tree(np_tree, device, "params", ("float32", "bfloat16"))


def cache_from_jax(np_tree: Mapping[str, Any], device=None):
    """Numpy copies of a decode cache (the reference's ``init_cache`` /
    ``serve_step`` output: f32 or bf16 leaves, int8 in the quantized KV
    layout) -> the port's nested dict of tensors."""
    return _tree(np_tree, device, "cache", ("float32", "bfloat16", "int8"))


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



def host_state_from_jax(state, updates, bcasts, device=None
                        ) -> Tuple[CohortState, UpdateBuckets, BroadcastRing]:
    """The reference host engine's ``CohortState``, ``UpdateBuckets`` and
    ``BroadcastRing`` — their fields as numpy copies (``w``/``U``/``v``,
    the bucket payloads and broadcast snapshots as arrays) — -> the
    port's, the float blocks on ``device``, the counters as int64 numpy."""
    ints = {f: np.array(getattr(state, f), dtype=np.int64)
            for f in ("i", "h", "k", "credit")}
    st = CohortState(w=_tensor(state.w, device), U=_tensor(state.U, device),
                     v=_tensor(state.v, device), server_k=int(state.server_k),
                     tick=int(state.tick), **ints)
    upd = UpdateBuckets(
        contrib={int(t): _tensor(v, device)
                 for t, v in updates.contrib.items()},
        far_contrib={int(t): _tensor(v, device)
                     for t, v in updates.far_contrib.items()},
        meta={int(t): [tuple(int(x) for x in p) for p in pairs]
              for t, pairs in updates.meta.items()})
    bc = BroadcastRing(pending=[
        {"k": int(b["k"]), "v": _tensor(b["v"], device),
         "at": np.array(b["at"], dtype=np.int64)} for b in bcasts.pending])
    return st, upd, bc


def event_models_from_jax(sim, server_v: Mapping[str, Any],
                          client_ws: Sequence[Mapping[str, Any]]):
    """Install numpy copies of a reference event simulator's models —
    the server's ``v`` and each client's ``w`` (logreg params) — into the
    port's ``AsyncFLSimulator`` ``sim`` on its device; returns ``sim``."""
    if len(client_ws) != len(sim.clients):
        raise ValueError(f"{len(client_ws)} client models for "
                         f"{len(sim.clients)} clients")
    sim.server.v = params_from_jax(server_v, sim.device)
    for cl, w in zip(sim.clients, client_ws):
        cl.w = params_from_jax(w, sim.device)
    return sim
