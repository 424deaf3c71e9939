"""Params-tree checkpointing (npz container + structure manifest).

The port's copy of ``repro.checkpoint.io``, in its file format: npz keys
are the leaves' paths (dict keys and sequence indices joined by ``/``),
``<path>.json`` is the manifest (keys, dtypes, shapes, metadata), and
dtypes numpy cannot hold (bf16) are widened to f32, which the template's
dtype restores on load.  A checkpoint written by either package loads in
the other.

FL-aware: ``save_fl_state`` persists the global model, server round
counter and per-client progress so an interrupted run resumes
mid-protocol (the paper's server/clients are long-running processes).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


def _paths(t, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in jax's leaf order."""
    if isinstance(t, dict):
        return [pl for k in sorted(t) for pl in _paths(t[k], prefix + (k,))]
    if isinstance(t, (list, tuple)):
        return [pl for i, x in enumerate(t) for pl in _paths(x, prefix + (i,))]
    return [(prefix, t)]


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten_with_paths(t) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in _paths(t):
        arr = _numpy(leaf)
        if arr.dtype.kind not in "fiub" or str(arr.dtype) == "bfloat16":
            # npz cannot round-trip bf16 and its kin: widen to f32
            # (lossless for bf16); the template dtype restores it on load
            arr = arr.astype(np.float32)
        flat[_key(path)] = arr
    return flat


def save_pytree(path: str, t, *, metadata: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(t)
    np.savez(path, **flat)
    manifest = {
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_pytree(path: str, template) -> Any:
    """Restore into the template's structure (keys must match), each
    leaf in its template leaf's dtype and on its device."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    out = []
    for path_k, leaf in _paths(template):
        arr = torch.as_tensor(data[_key(path_k)])
        out.append(arr.to(dtype=leaf.dtype, device=leaf.device)
                   if torch.is_tensor(leaf) else arr)
    return tree.unflatten(template, out)


def save_fl_state(directory: str, *, global_model, server_k: int,
                  client_states: Optional[Dict[int, Dict]] = None,
                  step_metadata: Optional[Dict] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    save_pytree(os.path.join(directory, "global_model.npz"), global_model,
                metadata={"server_k": server_k, **(step_metadata or {})})
    if client_states:
        summary = {str(c): {k: v for k, v in st.items()
                            if isinstance(v, (int, float, str))}
                   for c, st in client_states.items()}
        with open(os.path.join(directory, "clients.json"), "w") as f:
            json.dump(summary, f, indent=1)


def load_fl_state(directory: str, template) -> Tuple[Any, int]:
    path = os.path.join(directory, "global_model.npz")
    model = load_pytree(path, template)
    with open(path + ".json") as f:
        manifest = json.load(f)
    return model, int(manifest["metadata"].get("server_k", 0))
