"""Per-architecture partition specs (the reference's rules, divisibility-
checked), and their DTensor placements.

The port's copy of ``repro.sharding.specs``.  A spec ``P`` names, per
tensor dim, the mesh axis (or tuple of axes) that shards it, or None;
``placements(mesh, spec)`` turns it into the DTensor placement list per
mesh dim, and a "sharding" in the port is ``(mesh, placements)``.

Strategy (the reference's):
  * ``model`` axis: tensor-parallel — shards attention head projections,
    MLP hidden, expert hidden, vocab (where divisible).
  * ``data`` axis: FSDP — shards the *other* matrix dimension of each
    large parameter (d_model side), plus the batch dimension of
    activations.
  * ``pod`` axis (multi-pod): FL clients — parameters are replicated
    across pods (each pod is one client cohort holding a full model
    replica, sharded within the pod); the FL server reduce is the only
    cross-pod collective, matching the paper's communication model.

Every rule degrades gracefully: an axis is applied to a tensor dimension
only when the dimension is divisible by the axis size, so every assigned
architecture places on both production meshes without bespoke cases.
The rules read a mesh's axis names and sizes only: a ``DeviceMesh`` or a
``MeshShape``.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, List, NamedTuple, Tuple

from repro_torch import tree

# Disable FSDP (data-axis) sharding of parameters — for models whose
# model-parallel shard already fits memory this removes the per-layer
# weight all-gather.  Read at import, as the reference reads it.
NO_FSDP = os.environ.get("REPRO_NO_FSDP", "0") == "1"


class P(tuple):
    """A partition spec: one entry per tensor dim — None, a mesh-axis
    name, or a tuple of names (the dim sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class MeshShape(NamedTuple):
    """The axis names and sizes of a mesh: all that the rules read."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str) -> int:
    return mesh_axis_sizes(mesh).get(name, 1)


def _fit(mesh, dim: int, axis: str):
    """Return axis name if dim divisible by its size, else None."""
    if axis == "data" and NO_FSDP:
        return None
    return axis if (axis in mesh.mesh_dim_names
                    and dim % _axis_size(mesh, axis) == 0
                    and _axis_size(mesh, axis) > 1) else None


def _spec_for(mesh, path: str, shape: Tuple[int, ...]) -> P:
    """Rule table keyed on parameter leaf name."""
    name = path.split("/")[-1]

    def fit(i, axis):
        return _fit(mesh, shape[i], axis)

    nd = len(shape)
    if name in ("embed", "unembed"):                       # (V, d)
        v_ax = fit(0, "model")
        d_ax = fit(1, "data")
        if v_ax is None:                                   # odd vocab sizes
            return P(None, fit(1, "model"))
        return P(v_ax, d_ax)
    if name in ("wq", "wk", "wv"):                         # (L, d, out)
        return P(None, fit(1, "data"), fit(2, "model"))
    if name == "wo":                                       # (L, out, d)
        return P(None, fit(1, "model"), fit(2, "data"))
    if name in ("wg", "wu"):
        if nd == 4:                                        # moe (L,E,d,ff)
            return P(None, None, fit(2, "data"), fit(3, "model"))
        return P(None, fit(1, "data"), fit(2, "model"))    # (L, d, ff)
    if name == "wd":
        if nd == 4:                                        # moe (L,E,ff,d)
            return P(None, None, fit(2, "model"), fit(3, "data"))
        return P(None, fit(1, "model"), fit(2, "data"))    # (L, ff, d)
    if name in ("shared_wg", "shared_wu"):                 # (L, d, sf)
        return P(None, fit(1, "data"), fit(2, "model"))
    if name == "shared_wd":                                # (L, sf, d)
        return P(None, fit(1, "model"), fit(2, "data"))
    if name == "router":                                   # (L, d, E)
        return P(None, fit(1, "data"), None)
    if name == "in_proj":                                  # (L, d, proj)
        return P(None, fit(1, "data"), fit(2, "model"))
    if name == "out_proj":                                 # (L, d_in, d)
        return P(None, fit(1, "model"), fit(2, "data"))
    if name == "conv_w":                                   # (L, conv_dim, W)
        return P(None, fit(1, "model"), None)
    if name in ("conv_b", "gate_norm"):                    # (L, conv_dim)
        return P(None, fit(1, "model"))
    if name in ("bq", "bk", "bv"):                         # (L, out)
        return P(None, fit(1, "model"))
    if name in ("bu",):                                    # (L, ff)
        return P(None, fit(1, "model"))
    if name in ("bd",):                                    # (L, d)
        return P(None, fit(1, "data"))
    # norms, dt_bias, A_log, D, scalars: replicate
    return P(*([None] * nd))


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def tree_map_with_path(fn, t, path=()):
    """``fn(path, leaf)`` over a nested-dict tree, ``path`` the keys."""
    if isinstance(t, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map_with_path(fn, v, path + (i,))
                       for i, v in enumerate(t))
    return fn(path, t)


def param_pspecs(mesh, params_shape: Any) -> Any:
    """Map a params tree (anything with ``.shape`` at the leaves) to
    partition specs."""
    return tree_map_with_path(
        lambda path, leaf: _spec_for(mesh, _path_str(path),
                                     tuple(leaf.shape)),
        params_shape)


def placements(mesh, spec) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` names that axis, else
    ``Replicate()``.  A dim naming several axes is split over them in
    mesh order (major first), as the reference's tuple entries are.  An
    axis of size 1 replicates (sharding over one rank is replication,
    as it is in the reference's specs)."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axis_sizes(mesh)
    out: List[Any] = []
    for name in mesh.mesh_dim_names:
        where = [i for i, e in enumerate(spec)
                 if e == name or (isinstance(e, (tuple, list)) and name in e)]
        if len(where) > 1:
            raise ValueError(f"axis {name!r} shards two dims in {spec}")
        out.append(Shard(where[0]) if where and sizes[name] > 1
                   else Replicate())
    return out


def param_shardings(mesh, params_shape: Any) -> Any:
    return tree.tree_map(lambda s: (mesh, placements(mesh, s)),
                         param_pspecs(mesh, params_shape))


# ---------------------------------------------------------------------------
# Cohort engine: client-axis sharding for [C, D] population state
# ---------------------------------------------------------------------------

def cohort_mesh(device=None):
    """1-D mesh over every rank of the default process group; axis
    ``clients`` shards the population axis of the cohort engines'
    stacked state.  ``device`` None is the card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.devices import resolve_device
    if not dist.is_initialized():
        raise RuntimeError("cohort_mesh needs an initialized process "
                           "group (torch.distributed.init_process_group)")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(dist.get_world_size()),
                      mesh_dim_names=("clients",))


def cohort_pspecs(mesh, n_clients: int) -> Dict[str, P]:
    """Field -> partition spec for ``DeviceCohortState``-shaped state.

    Client-axis fields ([C, ...] or [..., C]) shard over ``clients`` when
    C is divisible by the axis size; the server model, the message rings'
    payloads ([L, D] / [B, D]) and all scalars replicate — they are what
    the batched server reduce touches, i.e. the FL analogue of the
    cross-pod reduce in the LLM mapping.
    """
    c_ax = _fit(mesh, n_clients, "clients")
    return {
        "w": P(c_ax, None), "U": P(c_ax, None), "v": P(None),
        "i": P(c_ax), "h": P(c_ax), "k": P(c_ax), "credit": P(c_ax),
        "server_k": P(), "tick": P(),
        "upd_vec": P(None, None), "upd_cnt": P(None, None),
        "h_counts": P(None),
        "bc_v": P(None, None), "bc_k": P(None), "bc_at": P(None, c_ax),
        "ovf_vec": P(None, None), "ovf_at": P(None),
        "ovf_cnt": P(None, None), "err": P(),
        "messages": P(), "broadcasts": P(),
        # telemetry counters: per-client census shards with the client
        # axis; the small histogram / ring-count arrays and scalar
        # high-water marks replicate like the message rings they mirror
        "part": P(c_ax), "bytes_up": P(c_ax),
        "stale_hist": P(None), "upd_ks": P(None, None),
        "ovf_ks": P(None, None), "ovf_hwm": P(), "far_msgs": P(),
        # aggregation-strategy buffers: server-side ring payloads and the
        # FedBuff accumulator replicate like the message rings they extend
        "upd_kvec": P(None, None, None), "ovf_kvec": P(None, None, None),
        "buf_vec": P(None), "buf_cnt": P(),
        # op-census vector: scalar-ish counter block, replicates
        "ops": P(None),
        # fused-loop iteration census ([loop_iters, block_iters])
        "iters": P(None),
    }


def client_range(mesh, n_clients: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of the client axis this rank holds under
    ``cohort_pspecs``: its equal block where ``_fit`` shards the axis
    over ``clients``, else (the axis replicated: C not divisible by the
    ranks, one rank, or no mesh) the whole population."""
    if mesh is None or _fit(mesh, n_clients, "clients") is None:
        return 0, int(n_clients)
    per = int(n_clients) // _axis_size(mesh, "clients")
    r = mesh.get_local_rank("clients")
    return r * per, (r + 1) * per


def cohort_shardings(mesh, n_clients: int) -> Dict[str, Any]:
    return {f: (mesh, placements(mesh, s))
            for f, s in cohort_pspecs(mesh, n_clients).items()}


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------

def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def batch_spec(mesh, batch_size: int, extra_dims: int = 1) -> P:
    """Shard the batch dim over (pod, data) when divisible."""
    axes = [a for a in batch_axes(mesh)
            if batch_size % _axis_size(mesh, a) == 0]
    # try combined first
    combined = batch_axes(mesh)
    total = math.prod(_axis_size(mesh, a) for a in combined)
    if combined and batch_size % total == 0:
        lead = combined if len(combined) > 1 else combined[0]
    elif axes:
        lead = axes[0]
    else:
        lead = None
    return P(lead, *([None] * extra_dims))


def client_batch_spec(mesh, per_client_batch: int,
                      extra_dims: int = 1) -> P:
    """(C, B, ...) batches: client axis over pod, batch over data."""
    c_ax = "pod" if "pod" in mesh.mesh_dim_names else None
    b_ax = _fit(mesh, per_client_batch, "data")
    return P(c_ax, b_ax, *([None] * extra_dims))


def cache_pspecs(mesh, cache_shape: Any) -> Any:
    """Decode-cache sharding: batch over (pod,data) if divisible, else
    shard heads / state over model; fall back to replication."""
    def spec(path, leaf):
        shape = tuple(leaf.shape)
        name = _path_str(path).split("/")[-1]
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S_cache, KV, hd)
            b = _fit_combined(mesh, shape[1])
            kv = _fit(mesh, shape[3], "model")
            s = None
            if kv is None:
                s = _fit(mesh, shape[2], "model")
            return P(None, b, s, kv, None)
        if name in ("k_scale", "v_scale"):
            # (L, B, S_cache, KV) — int8-KV scales, mirror the kv layout
            b = _fit_combined(mesh, shape[1])
            kv = _fit(mesh, shape[3], "model")
            s = None
            if kv is None:
                s = _fit(mesh, shape[2], "model")
            return P(None, b, s, kv)
        if name == "h":          # ssm state (L, B, H, N, P)
            b = _fit_combined(mesh, shape[1])
            h_ax = _fit(mesh, shape[2], "model")
            return P(None, b, h_ax, None, None)
        if name == "conv":       # (L, B, W-1, conv_dim)
            b = _fit_combined(mesh, shape[1])
            return P(None, b, None, _fit(mesh, shape[3], "model"))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec, cache_shape)


def _fit_combined(mesh, dim: int):
    combined = batch_axes(mesh)
    total = math.prod(_axis_size(mesh, a) for a in combined)
    if combined and dim % total == 0 and total > 1:
        return combined if len(combined) > 1 else combined[0]
    for a in combined:
        if dim % _axis_size(mesh, a) == 0 and _axis_size(mesh, a) > 1:
            return a
    return None
