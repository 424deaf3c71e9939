"""Multi-pod dry run: trace every (arch x shape x mesh) step on fake ranks.

The port's copy of ``repro.launch.dryrun``.  For each pair it builds the
sharding-annotated step, makes its inputs as fake-tensor DTensors on a
``DeviceMesh`` over a fake process group of 256 or 512 ranks (nothing is
allocated; one process stands for every rank), runs the step once under
``FakeTensorMode`` with a ``roofline.StepCounter`` below DTensor, and
records the memory analysis, flops, bytes and collective bytes for the
roofline.  Where XLA's SPMD partitioner chooses a layout for itself,
DTensor's sharding propagation does here, with ``_PlanMode`` above it: a
reshape that would fold a sharded dim into the dim before it (a
``_StridedShard``, which DTensor cannot move on fake tensors) first
gathers that dim — the all-gather ahead of a sequence-parallel
projection — and an op DTensor cannot place (no strategy, or a failed
propagation) has its operands gathered and runs on them, as XLA would
insert the collective; every gather is counted.

Memory analysis, per rank: ``argument_size_in_bytes`` and
``output_size_in_bytes`` are the local shards' bytes;
``temp_size_in_bytes`` is the peak of live fake storage above the
arguments during the step (kernels' internal workspaces included at
their call); ``generated_code_size_in_bytes`` is 0 — eager PyTorch
compiles no program for the step (the CUDA kernels' libraries are
built once, outside it).

Depth: the port's layers run as a Python loop, each layer traced and
counted, so the full-depth count is exact; ``corrected_costs`` (the
reference's extrapolation from two reduced-depth variants, which XLA
needs because it counts a while-loop body once) is kept as a check
against it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k [--multi-pod] [--all] [--out reports/] \\
        [--device cpu]

``--device`` None is the card's device type (fake CUDA tensors: the
kernels' custom ops trace through their fake implementations); ``cpu``
runs the plain versions, as the CPU tests do.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, RunConfig,
                                 get_config)
from repro_torch.core import fl_step
from repro_torch.launch import inputs as inputs_mod
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.sharding import context
from repro_torch.sharding.context import (use_activation_spec,
                                          use_param_cotangent_specs)
from repro_torch.sharding.specs import P

ACT_SPEC_MODE = os.environ.get("REPRO_ACT_SPEC", "seqpar")


def act_spec(shape_kind: str, mesh) -> P:
    """Batch-leading activation spec for full-sequence passes.

    Inside the per-client loop (train, multi-pod) the client axis is the
    pod, so the inner batch pins only 'data'; prefill has no client axis
    and uses the combined axes.

    Modes (REPRO_ACT_SPEC):
      dataonly — batch over data, sequence unsharded (naive data
                 parallelism)
      seqpar   — batch over data, sequence over model (sequence
                 parallelism; the default)
      flatbatch— batch over BOTH axes (when the per-client batch is a
                 multiple of 256; removes seq-parallel collectives)
    """
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in ("pod", "data") if a in names)
    if shape_kind == "train":
        if ACT_SPEC_MODE == "dataonly":
            return P("data")
        if ACT_SPEC_MODE == "flatbatch":
            return P(("data", "model"))
        return P("data", "model")
    combined = axes if len(axes) > 1 else axes[0]
    if ACT_SPEC_MODE == "dataonly":
        return P(combined)
    if ACT_SPEC_MODE == "flatbatch":
        flat = tuple(a for a in ("pod", "data", "model")
                     if a in names + ("model",))
        return P(tuple(dict.fromkeys(flat)))
    return P(combined, "model")


def build_step(cfg, run_cfg, shape, mesh, *, unroll: bool = False,
               dtype=torch.bfloat16):
    """Returns (fn, example_args); call it under the dry run's fake mode
    (``trace``) or with a real mesh."""
    kind = shape.kind
    spec = inputs_mod.shape_inputs(cfg, shape, mesh, dtype=dtype)
    aspec = act_spec(kind, mesh)
    if kind == "train":
        C = inputs_mod.n_client_shards(mesh)
        cot_specs = None
        if os.environ.get("REPRO_GRAD_RS", "1") == "1":
            blocks = spec["param_specs"].get("blocks")
            if blocks is not None:
                cot_specs = _drop_leading(blocks)
        raw_step = fl_step.make_train_step(
            cfg, run_cfg, n_client_shards=C,
            client_axis="pod" if C > 1 else None, unroll=unroll,
            grad_pspecs=spec["param_specs"])

        def step(*a, _raw=raw_step, _sp=aspec, _cs=cot_specs):
            with use_activation_spec(_sp), use_param_cotangent_specs(_cs):
                return _raw(*a)
        args = (spec["params"], spec["momentum"], spec["batch"],
                spec["eta_bar"], spec["rng"])
        return step, args
    if kind == "prefill":
        raw_step = fl_step.make_prefill_step(cfg, run_cfg, unroll=unroll)

        def step(*a, _raw=raw_step, _sp=aspec):
            with use_activation_spec(_sp):
                return _raw(*a)
        return step, (spec["params"], spec["batch"])
    # decode
    step = fl_step.make_serve_step(cfg, run_cfg, seq_len=shape.seq_len,
                                   unroll=unroll)
    return step, (spec["params"], spec["cache"], spec["tokens"],
                  spec["pos"])


def _drop_leading(specs):
    """Per-layer specs: each stacked leaf's spec without its L dim."""
    if isinstance(specs, dict):
        return {k: _drop_leading(v) for k, v in specs.items()}
    return P(*tuple(specs)[1:])


# ---------------------------------------------------------------------------
# Tracing on fake ranks
# ---------------------------------------------------------------------------

def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _flat(xs):
    return roofline._tensors(list(xs))


# ops that turn a Python constant into a tensor: the fake mode's own
_LIFTS = (torch.ops.aten.lift_fresh.default,
          torch.ops.aten.lift_fresh_copy.default)


class _PlanMode(TorchDispatchMode):
    """Above DTensor: runs host-scalar ops (all tensor operands real CPU
    tensors: the step size, the PRNG key) for real, and where DTensor
    cannot place an op on fake ranks, gathers its operands and retries
    (the gathers reported to the counter as the collectives they are)."""

    def __init__(self, counter: roofline.StepCounter):
        super().__init__()
        self.counter = counter
        self.fallbacks: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        ts = _flat(list(args) + list(kwargs.values()))
        if ts and func not in _LIFTS and not any(
                isinstance(t, DTensor) or _is_fake(t) for t in ts):
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func in _VIEWS and isinstance(args[0], DTensor):
            args = (_gather_minor(args[0], args[1], self.counter),) \
                + tuple(args[1:])
        snap = self.counter.snapshot()
        try:
            return func(*args, **kwargs)
        except Exception as first:  # noqa: BLE001 — DTensor cannot place it
            fixes = ((_gather_reshaped,) if func in _VIEWS else ()) \
                + (_gather_strided, _gather_all, None)
            for fix in fixes:
                self.counter.restore(snap)   # a failed try counts nothing
                try:
                    if fix is None:
                        out = _run_replicated(func, args, kwargs,
                                              self.counter)
                    else:
                        a2, k2 = fix(args, kwargs, self.counter)
                        out = func(*a2, **k2)
                except Exception:  # noqa: BLE001
                    continue
                self.fallbacks[str(func)] = \
                    self.fallbacks.get(str(func), 0) + 1
                return _inplace_result(func, args, out)
            self.counter.restore(snap)
            raise first


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default)


def _reshape_groups(src, dst):
    """The groups of a reshape ``src`` -> ``dst``: (input dims, number of
    output dims) that map onto each other, size-1 dims aside."""
    src, dst = list(src), list(dst)
    n = 1
    for s in src:
        n *= s
    if -1 in dst:
        known = 1
        for d in dst:
            known *= d if d != -1 else 1
        dst[dst.index(-1)] = n // known if known else 0
    src_nz = [(i, s) for i, s in enumerate(src) if s != 1]
    dst_nz = [d for d in dst if d != 1]
    groups, i, j = [], 0, 0
    while i < len(src_nz) and j < len(dst_nz):
        dims, ps, pd, nd = [src_nz[i][0]], src_nz[i][1], dst_nz[j], 1
        while ps != pd:
            if ps < pd:
                i += 1
                if i >= len(src_nz):
                    return groups
                dims.append(src_nz[i][0])
                ps *= src_nz[i][1]
            else:
                j += 1
                if j >= len(dst_nz):
                    return groups
                pd *= dst_nz[j]
                nd += 1
        groups.append((dims, nd))
        i, j = i + 1, j + 1
    return groups


def _minor_merged_dims(src, dst):
    """Input dims a reshape folds into an output dim led by an earlier
    input dim."""
    return {d for dims, _ in _reshape_groups(src, dst) for d in dims[1:]}


def _reshaped_dims(src, dst):
    """Input dims a reshape merges or splits."""
    return {d for dims, nd in _reshape_groups(src, dst)
            if len(dims) > 1 or nd > 1 for d in dims}


def _gather_dims(x, dims, counter):
    """``x`` with its shards on ``dims`` gathered."""
    return _regather(x, lambda p: not (p.is_shard() and p.dim in dims),
                     counter)


def _gather_minor(x, shape, counter):
    """Before a reshape that folds a sharded dim into the dim before it
    (DTensor would place the result as a ``_StridedShard``, which it
    cannot move on fake tensors), gather that dim: sequence parallelism's
    all-gather ahead of the projection.  Counted."""
    return _gather_dims(x, _minor_merged_dims(tuple(x.shape), tuple(shape)),
                        counter)


def _run_replicated(func, args, kwargs, counter):
    """An op DTensor has no strategy for: every operand gathered whole,
    the op run on the local (now global) tensors, its tensor results
    replicated over the mesh."""
    from torch.distributed.tensor import DTensor, Replicate
    a2, k2 = _gather_all(args, kwargs, counter)
    mesh = next(t.device_mesh for t in _flat(list(a2) + list(k2.values()))
                if isinstance(t, DTensor))
    a3, k3 = _map_dtensors(lambda x: x._local_tensor, a2, k2)
    out = func(*a3, **k3)

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        if isinstance(o, (list, tuple)):
            return type(o)(wrap(x) for x in o)
        return o
    return wrap(out)


def _inplace_result(func, args, out):
    """An in-place op's result is its first operand."""
    if func._schema.name.endswith("_") and args and \
            isinstance(args[0], torch.Tensor):
        return args[0]
    return out


def _fresh(mesh, local_like, shape, stride, pls):
    """A DTensor of global ``shape`` placed ``pls``, its local shard made
    afresh (fake ranks: no data to move, only shapes and bytes) in
    ``local_like``'s dtype and device."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(context.local_shape(shape, mesh, pls),
                        dtype=local_like.dtype, device=local_like.device)
    return DTensor.from_local(local, mesh, pls, shape=shape,
                              stride=stride, run_check=False)


def _kind(src, dst) -> str:
    """The collective that takes placements ``src`` to ``dst``."""
    if any(s.is_partial() for s in src):
        return "reduce_scatter" if any(d.is_shard() for d in dst) \
            else "all_reduce"
    if any(s.is_shard() and d.is_shard() and s != d
           for s, d in zip(src, dst)):
        return "all_to_all"
    return "all_gather"


def _regather(x, keep, counter):
    """``x`` (a DTensor) with each placement that ``keep`` rejects made
    Replicate: on fake ranks its local shard made afresh and the gather
    counted, on real ones redistributed."""
    from torch.distributed.tensor import Replicate
    pls = [p if keep(p) else Replicate() for p in x.placements]
    if pls == list(x.placements):
        return x
    if not _is_fake(x._local_tensor):
        return x.redistribute(x.device_mesh, pls)
    out = _fresh(x.device_mesh, x._local_tensor, tuple(x.shape),
                 x.stride(), pls)
    lt = out._local_tensor
    counter.add_collective(_kind(x.placements, pls),
                           lt.numel() * lt.element_size())
    return out


def _map_dtensors(fn, args, kwargs):
    from torch.distributed.tensor import DTensor

    def one(a):
        if isinstance(a, DTensor):
            return fn(a)
        if isinstance(a, (list, tuple)):
            return type(a)(one(x) for x in a)
        return a
    return one(tuple(args)), {k: one(v) for k, v in kwargs.items()}


def _gather_strided(args, kwargs, counter):
    from torch.distributed.tensor.placement_types import _StridedShard
    return _map_dtensors(
        lambda x: _regather(x, lambda p: not isinstance(p, _StridedShard),
                            counter), args, kwargs)


def _gather_reshaped(args, kwargs, counter):
    """A reshape DTensor cannot place: gather the shards of the dims it
    merges or splits, keep the others (the batch shard)."""
    x = args[0]
    dims = _reshaped_dims(tuple(x.shape), tuple(args[1]))
    return (_gather_dims(x, dims, counter),) + tuple(args[1:]), kwargs


def _gather_all(args, kwargs, counter):
    return _map_dtensors(
        lambda x: _regather(x, lambda p: p.is_replicate(), counter),
        args, kwargs)


@dataclasses.dataclass
class StepCounts:
    """What one traced (or real) step counted, per rank."""
    flops: int
    bytes: int
    coll: Dict[str, int]
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    fallbacks: Dict[str, int]


def trace(fn, args) -> StepCounts:
    """Run ``fn(*args)`` once under the counters, on the fake ranks its
    DTensor inputs live on (call inside the ``FakeTensorMode`` that made
    them), or for real on a real mesh."""
    c = roofline.StepCounter(known=tree.leaves(list(args)))
    with c, placed(c) as plan:
        out = fn(*args)
    arg_b = inputs_mod.local_bytes(list(args))
    out_b = inputs_mod.local_bytes(list(out) if isinstance(out, tuple)
                                   else [out])
    return StepCounts(flops=c.flops, bytes=c.bytes, coll=dict(c.coll),
                      argument_bytes=arg_b, output_bytes=out_b,
                      temp_bytes=c.peak, fallbacks=plan.fallbacks)


@contextlib.contextmanager
def placed(counter: Optional[roofline.StepCounter] = None):
    """Run DTensor code as the dry run does, on fake or real ranks: plain
    tensors replicate implicitly, and ``_PlanMode`` places what DTensor
    has no strategy for (on real ranks by real redistributions)."""
    from torch.distributed.tensor.experimental import implicit_replication
    plan = _PlanMode(counter or roofline.StepCounter())
    with implicit_replication(), plan:
        yield plan


_REGISTERED = []


def register_kernel_rules() -> None:
    """Sharding rules and workspace sizes of the model-path kernels' custom
    ops (once per process)."""
    if _REGISTERED:
        return
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ss_ops
    fa_ops.register_sharding_rule()
    ss_ops.register_sharding_rule()
    roofline.register_transient(
        torch.ops.repro_torch.ssd_scan.default,
        lambda x, dt, A, B, C, chunk, h0: ss_ops.workspace_bytes(
            x.shape, B.shape, chunk))
    _REGISTERED.append(True)


def count_step(cfg, run_cfg, shape, mesh, *, unroll: bool = False,
               dtype=torch.bfloat16) -> StepCounts:
    """Build the step's fake inputs on ``mesh`` and trace it once."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    register_kernel_rules()
    with FakeTensorMode():
        step, args = build_step(cfg, run_cfg, shape, mesh, unroll=unroll,
                                dtype=dtype)
        return trace(step, args)


def fill_inputs(args, vocab_size: int, seed: int = 0) -> None:
    """Give a step's real inputs (``build_step`` on a real mesh, outside
    any fake mode) values from ``seed``, in place: token ids below
    ``vocab_size``, int8 cache entries in [-127, 127], floats ~ N(0,
    0.02^2).  The host scalars keep theirs."""
    from torch.distributed.tensor import DTensor
    gens = {}
    for leaf in tree.leaves(list(args)):
        if not isinstance(leaf, DTensor):
            continue
        t = leaf._local_tensor
        g = gens.get(t.device)
        if g is None:
            g = gens[t.device] = torch.Generator(
                device=t.device).manual_seed(seed)
        if t.dtype == torch.int32:
            t.random_(0, vocab_size, generator=g)
        elif t.dtype == torch.int8:
            t.random_(-127, 128, generator=g)
        else:
            t.normal_(0.0, 0.02, generator=g)


# ---------------------------------------------------------------------------
# Depth: the reference's extrapolation, kept as a check
# ---------------------------------------------------------------------------

def analysis_variant(cfg, n_layers: int):
    """Reduced-depth, same-width config for trip-count-exact costing."""
    upd = {"n_layers": n_layers}
    if cfg.family == "encdec":
        upd["n_encoder_layers"] = n_layers
    if cfg.global_layers:
        upd["global_layers"] = tuple(
            g for g in cfg.global_layers if g < n_layers) or (0,)
    return dataclasses.replace(cfg, **upd)


def variant_costs(cfg, run_cfg, shape, mesh, n_layers: int):
    """(flops, bytes, coll_bytes) of a reduced-depth variant, all chips."""
    vcfg = analysis_variant(cfg, n_layers)
    c = count_step(vcfg, run_cfg, shape, mesh)
    chips = n_chips(mesh)
    return (c.flops * chips, c.bytes * chips,
            {k: v * chips for k, v in c.coll.items()})


def corrected_costs(cfg, run_cfg, shape, mesh):
    """Linear extrapolation: cost(L) = c(P) + (L/P-1)(c(2P)-c(P)), P the
    local/global period.  The reference's correction for XLA counting a
    loop body once; the port counts every layer, so this must equal the
    full-depth count wherever every group of P layers is alike."""
    P_ = cfg.local_global_period or 1
    L = cfg.n_layers
    f1, b1, c1 = variant_costs(cfg, run_cfg, shape, mesh, P_)
    f2, b2, c2 = variant_costs(cfg, run_cfg, shape, mesh, 2 * P_)
    groups = L // P_
    flops = f1 + (groups - 1) * (f2 - f1)
    byts = b1 + (groups - 1) * (b2 - b1)
    coll = {k: c1.get(k, 0) + (groups - 1) * (c2.get(k, 0) - c1.get(k, 0))
            for k in set(c1) | set(c2)}
    return flops, byts, coll


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool,
               verbose: bool = True, with_roofline: bool = None,
               device=None, cfg=None, mesh=None, shape=None) -> dict:
    """One (arch, shape, mesh) row.  ``cfg`` / ``mesh`` / ``shape``
    override the registry's config, the production mesh and the named
    input shape (the tests' cuts)."""
    if with_roofline is None:
        with_roofline = not multi_pod   # roofline table is single-pod only
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    shape_name = shape.name
    ok, why = (inputs_mod.shape_is_applicable(cfg, shape_name)
               if shape_name in INPUT_SHAPES else (True, ""))
    mesh_name = (mesh_label(mesh) if mesh is not None
                 else "2x16x16" if multi_pod else "16x16")
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIP", "reason": why}
    run_cfg = RunConfig(model=cfg, shape=shape_name)
    t0 = time.time()
    try:
        if mesh is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        counts = count_step(cfg, run_cfg, shape, mesh)
        chips = n_chips(mesh)
        report = roofline.analyze(counts, cfg=cfg, shape=shape,
                                  mesh_name=mesh_name, chips=chips,
                                  compile_seconds=time.time() - t0)
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "status": "OK", "roofline": report.to_dict(),
                  "memory_analysis": {
                      "temp_size_in_bytes": float(counts.temp_bytes),
                      "argument_size_in_bytes": float(counts.argument_bytes),
                      "output_size_in_bytes": float(counts.output_bytes),
                      "generated_code_size_in_bytes": 0.0},
                  "fallbacks": counts.fallbacks}
        if with_roofline:
            flops, byts, coll = corrected_costs(cfg, run_cfg, shape, mesh)
            result["corrected_costs"] = {
                "flops": float(flops), "bytes": float(byts),
                "coll_bytes": float(sum(coll.values())),
                "equal": (flops == counts.flops * chips
                          and byts == counts.bytes * chips
                          and sum(coll.values())
                          == sum(counts.coll.values()) * chips)}
        if verbose:
            print(report.row(), flush=True)
            print(f"  bytes/device: args="
                  f"{counts.argument_bytes/1e9:.2f}GB "
                  f"temp={counts.temp_bytes/1e9:.2f}GB "
                  f"trace={time.time() - t0:.1f}s", flush=True)
        return result
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        if verbose:
            print(f"{arch} {shape_name} {mesh_name} FAIL: {e}", flush=True)
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "FAIL", "error": str(e)[:2000],
                "compile_seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch.json")
    ap.add_argument("--device", default=None,
                    help="cpu to trace the plain versions on the CPU "
                         "(default: the card's device type)")
    args = ap.parse_args(argv)

    from repro_torch.devices import resolve_device
    resolve_device(args.device)           # no CUDA: raise unless cpu
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    t0 = time.time()
    results = []
    for multi_pod in meshes:
        for arch in archs:
            for shape_name in shapes:
                results.append(dryrun_one(arch, shape_name,
                                          multi_pod=multi_pod,
                                          device=args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # merge with existing results (sweeps run incrementally)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    key = lambda r: (r["arch"], r["shape"], r["mesh"])  # noqa: E731
    merged = {key(r): r for r in existing}
    for r in results:
        merged[key(r)] = r
    with open(args.out, "w") as f:
        json.dump(list(merged.values()), f, indent=1)
    n_fail = sum(1 for r in results if r["status"] == "FAIL")
    print(f"\n{len(results)} runs, {n_fail} failures -> {args.out} "
          f"({time.time() - t0:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

