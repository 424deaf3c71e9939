"""Roofline terms of a traced step, on NVIDIA H100 constants.

Three terms per (arch, shape, mesh), in seconds:

    compute    = flops       / (chips * PEAK_FLOPS)
    memory     = bytes       / (chips * HBM_BW)
    collective = coll_bytes  / (chips * LINK_BW)

The counts come from ``StepCounter``, a ``TorchDispatchMode`` under
DTensor that sees each rank's local ops (one process stands for every
rank, so a count is rank 0's times the chips):
  * flops: ``FlopCounterMode``'s formulas (matmuls, attention,
    convolutions, and the custom kernel ops' own formulas) over the
    local ops;
  * bytes: every aten op's inputs and outputs, each tensor counted over
    the elements it addresses (a broadcast dim once), views and
    allocations excluded — what eager PyTorch moves through HBM, the
    counterpart of XLA's "bytes accessed";
  * collective bytes: the result bytes of every ``_c10d_functional``
    collective the step issues, by kind (the counterpart of parsing the
    reference's HLO text);
  * the peak of live storage above the arguments (``peak_bytes``), with
    each kernel's internal workspaces (``TRANSIENT``) held for its call.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) gives the useful-
compute ratio that flags recomputation and redundancy.
"""
from __future__ import annotations

import sys
import weakref
from dataclasses import asdict, dataclass
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Datasheet constants of one NVIDIA H100 SXM5 80GB, 700 W (NVIDIA H100
# Tensor Core GPU data sheet, dense rates without sparsity):
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
# The 16x16 mesh is 256 cards in 32 eight-card nodes, so every mesh axis
# of 16 crosses nodes: its links are each card's own 400 Gb/s NDR
# InfiniBand port (NVIDIA DGX H100 data sheet: eight ConnectX-7, one per
# GPU), not NVLink 4's 450 GB/s a direction within a node.
LINK_BW = 50e9               # bytes/s per card, one direction

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
               "permute")

_funcol = torch.ops._c10d_functional
_KIND = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_gather_into_tensor_out": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "broadcast": "permute", "broadcast_": "permute",
}
# ops that move no data: allocations without a fill, and waits (and any
# op without a tensor result: a size, a device, a scalar read)
_NO_BYTES = {"empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "wait_tensor", "lift_fresh", "detach",
             "_local_scalar_dense", "alias", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset"}

#: op -> fn(*args) giving bytes the op allocates inside its call beside
#: its outputs (filled by ``register_transient``)
TRANSIENT: Dict[object, Callable[..., int]] = {}


def register_transient(op, fn: Callable[..., int]) -> None:
    TRANSIENT[op] = fn


def _tensors(xs):
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (where its storage lives), else ``t``."""
    return getattr(t, "_local_tensor", t)


def addressed_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a stride-0 (broadcast) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _in_sharding_propagation(depth: int = 48) -> bool:
    """True inside DTensor's sharding propagation, which runs the op once
    on global-shaped fake tensors to learn its output's metadata: not a
    rank's work, so not counted."""
    f = sys._getframe(2)
    while f is not None and depth:
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f, depth = f.f_back, depth - 1
    return False


class StepCounter(TorchDispatchMode):
    """Counts flops, bytes, collective bytes and the live-storage peak of
    the local (per-rank) ops.  DTensor ops pass through it (it returns
    NotImplemented, so DTensor runs and its local ops come back here)."""

    def __init__(self, known=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._known = set()
        for t in _tensors(list(known)):
            self._known.add(id(_local(t).untyped_storage()))

    def snapshot(self):
        return self.flops, self.bytes, dict(self.coll)

    def restore(self, snap) -> None:
        self.flops, self.bytes, coll = snap
        self.coll = dict(coll)

    def add_collective(self, kind: str, nbytes: int) -> None:
        """Count a collective made outside dispatch (the dry run's gathers
        on fake ranks)."""
        self.coll[kind] += int(nbytes)

    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        k = id(s)
        if k in self._live or k in self._known:
            return
        n = s.nbytes()
        self._live[k] = n
        self.live += n
        weakref.finalize(s, self._free, k)

    def _free(self, k: int) -> None:
        self.live -= self._live.pop(k, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        name = func._overloadpacket.__name__
        packet = func._overloadpacket
        outs = _tensors([out])
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        kind = _KIND.get(name) if func.namespace in (
            "_c10d_functional", "c10d", "c10d_functional") else None
        if kind is not None:
            self.coll[kind] += sum(t.numel() * t.element_size()
                                   for t in outs)
        elif outs and not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(addressed_bytes(t)
                              for t in _tensors(args) + _tensors(
                                  list(kwargs.values())) + outs)
        for t in outs:
            self._track(t)
        extra = TRANSIENT.get(func)
        self.peak = max(self.peak, self.live
                        + (extra(*args, **kwargs) if extra else 0))
        return out


def model_flops(cfg, shape, *, backward: bool) -> float:
    """MODEL_FLOPS = 6*N*D for train (fwd+bwd), 2*N*D for inference,
    using active params for MoE.  D = processed tokens."""
    n_total = cfg.param_count()
    if cfg.n_experts:
        # swap full expert compute for top-k + shared
        d = cfg.d_model
        per_layer_all = cfg.n_experts * 3 * d * cfg.moe_d_ff
        active_frac = cfg.moe_top_k / cfg.n_experts
        per_layer_active = per_layer_all * active_frac \
            + cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        n_active = n_total - cfg.n_layers * (per_layer_all
                                             + cfg.n_shared_experts * 3 * d
                                             * cfg.moe_d_ff) \
            + cfg.n_layers * per_layer_active
    else:
        n_active = n_total
    # the input-embedding LOOKUP does no matmul: subtract one table when
    # untied; tied models reuse the same table for the unembed matmul
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1   # decode: one token per sequence
    return 2.0 * n_active * tokens


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: Dict[str, int]
    model_flops_total: float
    bytes_per_device: float = 0.0
    compile_seconds: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops_total / self.hlo_flops \
            if self.hlo_flops else 0.0

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_ratio=self.useful_ratio)
        return d

    def row(self) -> str:
        return (f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} "
                f"compute={self.compute_s:9.3e}s mem={self.memory_s:9.3e}s "
                f"coll={self.collective_s:9.3e}s -> {self.dominant:10s} "
                f"useful={self.useful_ratio:6.3f}")


def analyze(counts, *, cfg, shape, mesh_name: str, chips: int,
            compile_seconds: float = 0.0) -> RooflineReport:
    """A report from one counted step (``counts``: rank 0's ``flops``,
    ``bytes``, ``coll``, ``argument_bytes`` and ``temp_bytes``, as
    ``dryrun.trace`` returns them): the counts times ``chips``;
    ``bytes_per_device`` is the arguments plus the live-storage peak."""
    coll = {k: int(v * chips) for k, v in counts.coll.items()}
    return RooflineReport(
        arch=cfg.arch_id, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=float(counts.flops * chips),
        hlo_bytes=float(counts.bytes * chips),
        coll_bytes=float(sum(coll.values())), coll_breakdown=coll,
        model_flops_total=model_flops(cfg, shape,
                                      backward=shape.kind == "train"),
        bytes_per_device=float(counts.argument_bytes + counts.temp_bytes),
        compile_seconds=compile_seconds)


__all__ = ["COLLECTIVES", "HBM_BW", "LINK_BW", "PEAK_FLOPS",
           "RooflineReport", "StepCounter", "addressed_bytes", "analyze",
           "model_flops", "register_transient"]
