"""Activation-sharding constraint context.

The port's copy of ``repro.sharding.context``.  Model code calls
:func:`constrain` on (B, S, d)-shaped residuals; when a spec is installed
(by the dry run's ``build_step``) **and** the tensor is a DTensor, the
tensor is redistributed to the spec's placements on its own mesh, the
counterpart of the reference's ``with_sharding_constraint``.  With no
spec installed, or on a plain tensor, every hook is the identity, so the
model code stays mesh-agnostic and the one-card path is unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.sharding.specs import P, placements

_ACTIVATION_SPEC: Optional[P] = None
_PARAM_COT_SPECS: Optional[Any] = None   # blocks-tree of per-layer specs


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def local_shape(shape, mesh, pls):
    """This rank's shard shape of a global ``shape`` placed ``pls`` on
    ``mesh`` (``torch.chunk``'s split: ceil-sized chunks, the last ones
    short or empty), in plain integers — no tensor op, so it runs under
    ``FakeTensorMode``."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if p.is_shard():
            n, r = mesh.size(i), coord[i]
            chunk = -(-out[p.dim] // n)
            out[p.dim] = max(0, min(chunk, out[p.dim] - r * chunk))
    return tuple(out)


def redistribute(x, pls):
    """``x`` (a DTensor) placed ``pls`` on its mesh."""
    pls = list(pls)
    if list(x.placements) == pls:
        return x
    return x.redistribute(x.device_mesh, pls)


class _CotangentSharding(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to
    ``pls`` (the counterpart of the reference's ``custom_vjp``
    ``_with_cotangent_sharding``)."""

    @staticmethod
    def forward(ctx, x, pls):
        ctx.pls = pls
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _is_dtensor(g):
            g = redistribute(g, ctx.pls)
        return g, None


@contextlib.contextmanager
def use_param_cotangent_specs(specs):
    """Install per-layer parameter-slice specs (leading L dim dropped).

    Pinning each layer's weight-gradient placements to the parameter's
    turns the gradient's reduction into a reduce-scatter instead of a
    full all-reduce.
    """
    global _PARAM_COT_SPECS
    prev = _PARAM_COT_SPECS
    _PARAM_COT_SPECS = specs
    try:
        yield
    finally:
        _PARAM_COT_SPECS = prev


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    return [t]


def _map_specs(fn, lp, specs):
    """``fn(leaf, spec)`` over a layer's params dict and the specs tree
    that mirrors it (a ``P`` is a leaf there, not a sequence)."""
    if isinstance(lp, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in lp.items()}
    return fn(lp, specs)


def shard_layer_param_cotangents(lp):
    """Apply cotangent-sharding to one layer's param slices (identity
    unless specs are installed and the slices are DTensors)."""
    if _PARAM_COT_SPECS is None or not any(
            _is_dtensor(a) for a in _leaves(lp)):
        return lp

    def one(a, sp):
        if not _is_dtensor(a) or not a.requires_grad:
            return a
        return _CotangentSharding.apply(a, placements(a.device_mesh, sp))
    return _map_specs(one, lp, _PARAM_COT_SPECS)


@contextlib.contextmanager
def use_activation_spec(spec: Optional[P]):
    global _ACTIVATION_SPEC
    prev = _ACTIVATION_SPEC
    _ACTIVATION_SPEC = spec
    try:
        yield
    finally:
        _ACTIVATION_SPEC = prev


def activation_spec() -> Optional[P]:
    return _ACTIVATION_SPEC


def installed_specs():
    """The (activation, parameter-cotangent) specs installed now: a body
    that runs again later (a checkpointed layer's rerun in backward)
    installs them again with ``use_specs``, as a traced body keeps the
    constraints it was traced with."""
    return _ACTIVATION_SPEC, _PARAM_COT_SPECS


@contextlib.contextmanager
def use_specs(specs):
    act, cot = specs
    with use_activation_spec(act), use_param_cotangent_specs(cot):
        yield


def _pin(x, spec):
    if not _is_dtensor(x):
        return x
    return redistribute(x, placements(x.device_mesh, spec))


def constrain_tree(t, specs):
    """Pin each DTensor leaf of the params-shaped tree ``t`` to its spec
    in ``specs`` (the reference's ``with_sharding_constraint(g,
    grad_pspecs)``); plain tensors pass through."""
    return _map_specs(lambda a, sp: _pin(a, sp), t, specs)


def constrain(x):
    """Pin an activation whose FIRST axis is the (per-client) batch."""
    if _ACTIVATION_SPEC is None:
        return x
    spec = tuple(_ACTIVATION_SPEC)
    extra = x.ndim - len(spec)
    if extra > 0:
        spec = spec + (None,) * extra
    elif extra < 0:
        spec = spec[:x.ndim]
    return _pin(x, P(*spec))


def constrain_tokens(x, dim: int = 0):
    """Pin a flattened-token dimension to ALL activation axes combined.

    Used for MoE dispatch/combine buffers whose leading dim is B*S (or
    expert-slot rows E*C): shards rows over ('data','model') jointly.
    """
    if _ACTIVATION_SPEC is None:
        return x
    axes = tuple(a for a in tuple(_ACTIVATION_SPEC) if a is not None)
    flat = []
    for a in axes:
        if isinstance(a, (tuple, list)):
            flat.extend(a)
        else:
            flat.append(a)
    if not flat:
        return x
    entry = tuple(flat) if len(flat) > 1 else flat[0]
    spec = [None] * x.ndim
    spec[dim] = entry
    return _pin(x, P(*spec))


def batch_model_axes():
    """(batch_axis_entry, model_axis_entry) from the installed spec."""
    if _ACTIVATION_SPEC is None:
        return None, None
    t = tuple(_ACTIVATION_SPEC)
    b = t[0] if len(t) > 0 else None
    m = t[1] if len(t) > 1 else None
    return b, m


def constrain_expert(x, *, last_is_ff: bool):
    """Pin MoE expert-region tensors (B, M, E, Cg, d|ff).

    The sequence-block axis M is UNSHARDED here — the model axis moves to
    the expert hidden dim instead, so expert weights keep their
    tensor-parallel sharding instead of being fully gathered.
    """
    if _ACTIVATION_SPEC is None:
        return x
    b, m = batch_model_axes()
    spec = [None] * x.ndim
    spec[0] = b
    if last_is_ff:
        spec[-1] = m
    return _pin(x, P(*spec))
