"""Fake-tensor DTensor inputs for every (arch x input-shape) pair.

The port's copy of ``repro.launch.inputs``: full-size, sharded stand-ins
— nothing is allocated in the dry run.  Each tensor is a DTensor over
the mesh whose local shard is a fake tensor (build under
``FakeTensorMode``), made with ``DTensor.from_local(..., shape=,
stride=, run_check=False)``.  The parameter and cache trees' shapes come
from the port's own ``init_params`` / ``init_cache`` on the ``meta``
device (the counterpart of ``jax.eval_shape``).  The modality frontends
(whisper conv/mel, chameleon VQ) appear as the stub embeddings/token
streams the reference prescribes.  The step's two host scalars — the
round step size and the PRNG key — stay real CPU tensors, as the
port's step reads them on the host.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from repro_torch import prng, tree
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import model as model_api
from repro_torch.sharding.context import contiguous_stride, local_shape
from repro_torch.sharding.specs import (P, batch_spec, cache_pspecs,
                                        client_batch_spec, param_pspecs,
                                        placements, tree_map_with_path)


def sds(mesh, shape, dtype, spec: P):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, its
    local shard an uninitialised tensor on the mesh's device (a fake
    one under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(int(x) for x in shape)
    pls = placements(mesh, spec)
    local = torch.empty(local_shape(shape, mesh, pls), dtype=dtype,
                        device=mesh.device_type)
    return DTensor.from_local(local, mesh, pls, shape=shape,
                              stride=contiguous_stride(shape),
                              run_check=False)


def n_client_shards(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return sizes.get("pod", 1)


def params_shapes(cfg: ModelConfig, dtype=torch.bfloat16) -> Any:
    """The params tree on the ``meta`` device: shapes and dtypes only
    (drawn outside any fake mode: the keys are real)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return model_api.init_params(cfg, prng.PRNGKey(0), dtype,
                                     device="meta")


def params_spec(cfg: ModelConfig, mesh, dtype=torch.bfloat16
                ) -> Tuple[Any, Any]:
    """(params tree of DTensors, partition-spec tree)."""
    shapes = params_shapes(cfg, dtype)
    specs = param_pspecs(mesh, shapes)
    params = tree_map_with_path(
        lambda path, s: sds(mesh, s.shape, s.dtype,
                            _at(specs, path)), shapes)
    return params, specs


def _at(t, path):
    for p in path:
        t = t[p]
    return t


def host_scalars() -> Dict[str, torch.Tensor]:
    """The round step size and the PRNG key, real CPU tensors."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        return {"eta_bar": torch.tensor(0.0, dtype=torch.float32),
                "rng": prng.PRNGKey(0)}


def train_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """Inputs of ``fl_step.make_train_step``: (params, momentum, batch,
    eta, rng)."""
    C = n_client_shards(mesh)
    B = shape.global_batch // C
    params, param_sp = params_spec(cfg, mesh, dtype)
    batch = {"tokens": sds(mesh, (C, B, shape.seq_len), torch.int32,
                           client_batch_spec(mesh, B, extra_dims=1))}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = sds(
            mesh, (C, B, cfg.encoder_seq_len, cfg.d_model), dtype,
            client_batch_spec(mesh, B, extra_dims=2))
    return {"params": params, "momentum": None, "batch": batch,
            **host_scalars(), "param_specs": param_sp}


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                   dtype=torch.bfloat16) -> Dict[str, Any]:
    params, param_sp = params_spec(cfg, mesh, dtype)
    batch = {"tokens": sds(mesh, (shape.global_batch, shape.seq_len),
                           torch.int32,
                           batch_spec(mesh, shape.global_batch,
                                      extra_dims=1))}
    if cfg.family == "encdec":
        batch["encoder_embeds"] = sds(
            mesh, (shape.global_batch, cfg.encoder_seq_len, cfg.d_model),
            dtype, batch_spec(mesh, shape.global_batch, extra_dims=2))
    return {"params": params, "batch": batch, "param_specs": param_sp}


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """long_500k uses the windowed-ring variant."""
    if shape.name == "long_500k" and cfg.sliding_window is not None:
        return int(cfg.sliding_window)
    return int(shape.seq_len)


def decode_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """``REPRO_KV_DTYPE=int8`` (read at call time) gives the quantized
    cache layout (int8 k/v, bf16 per-(token, head) scales)."""
    params, param_sp = params_spec(cfg, mesh, dtype)
    B = shape.global_batch
    cache_len = decode_cache_len(cfg, shape)
    kv_dtype = torch.int8 if os.environ.get("REPRO_KV_DTYPE") == "int8" \
        else dtype
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():
        shapes = model_api.init_cache(cfg, B, cache_len, kv_dtype,
                                      device="meta")
    cache_sp = cache_pspecs(mesh, shapes)
    cache = tree_map_with_path(
        lambda path, s: sds(mesh, s.shape, s.dtype, _at(cache_sp, path)),
        shapes)
    return {"params": params, "cache": cache,
            "tokens": sds(mesh, (B, 1), torch.int32,
                          batch_spec(mesh, B, extra_dims=1)),
            "pos": shape.seq_len - 1, "param_specs": param_sp,
            "cache_specs": cache_sp}


def input_specs(cfg: ModelConfig, shape_name: str, mesh, *,
                dtype=torch.bfloat16) -> Dict[str, Any]:
    return shape_inputs(cfg, INPUT_SHAPES[shape_name], mesh, dtype=dtype)


def shape_inputs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 dtype=torch.bfloat16) -> Dict[str, Any]:
    """``input_specs`` of a ``ShapeConfig`` (one of ``INPUT_SHAPES`` or a
    cut of one)."""
    if shape.kind == "train":
        return train_inputs(cfg, shape, mesh, dtype=dtype)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape, mesh, dtype=dtype)
    return decode_inputs(cfg, shape, mesh, dtype=dtype)


def shape_is_applicable(cfg: ModelConfig,
                        shape_name: str) -> Tuple[bool, str]:
    shape = INPUT_SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.supports_long_context():
        return False, ("pure full-attention arch: long_500k requires a "
                       "sub-quadratic variant (see DESIGN.md §4)")
    return True, ""


def local_bytes(*trees) -> int:
    """Bytes of the local shards (per rank) of the tensors in ``trees``."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in trees:
        for leaf in tree.leaves(t):
            if isinstance(leaf, DTensor):
                leaf = leaf._local_tensor
            if isinstance(leaf, torch.Tensor):
                n += leaf.numel() * leaf.element_size()
    return n
