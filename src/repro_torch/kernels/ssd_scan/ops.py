"""Dispatch for the SSD scan kernel: by the tensors' device.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version (``ssd_chunked``).  The kernels have no
backward: on the card an input that requires grad, in grad mode,
raises.  ``ssd_scan`` returns ``(y, final_state)``, the contract of
``apply_ssm``'s ``ssd_fn`` hook; ``ssd`` returns ``y`` alone, as the
reference's ``ops.ssd``.

The kernel is also the custom op ``torch.ops.repro_torch.ssd_scan``
(its CUDA implementation is the launcher, on operands already in the
kernel's dtypes), which a tensor subclass on the card — a fake tensor of
the dry run, a DTensor — goes through, so that fake tensors
(``register_fake``), ``FlopCounterMode`` (``flops``, the four phases'
products) and DTensor (``register_sharding_rule``: batch or heads
sharded, sequence and state dims whole) can trace it without a data
pointer.  A plain CUDA tensor calls the launcher directly.
``workspace_bytes`` is what the kernel allocates inside the call beside
its outputs.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.kernels.tick_fused.ops import no_backward, on_cuda

F32 = torch.float32
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return ssd_scan_kernel(x, dt, A, B, C, chunk, initial_state)


@ssd_scan_op.register_fake
def _(x, dt, A, B, C, chunk, initial_state):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, B.shape[-1], p), dtype=F32))


def _dims(x_shape, B_shape, chunk: int):
    b, s, h, p = x_shape
    Q = min(chunk, s)
    return b, s, h, p, B_shape[-1], Q, -(-s // Q)


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk, *args,
          out_shape=None, **kwargs) -> int:
    """2 flops per multiply-add of the four phases: C·Bᵀ (Q×n×Q per
    chunk), each chunk's state (Q×n×p per head), the state passing (n×p
    per head and chunk), and the outputs ((Q×Q + Q×n)×p per head)."""
    b, s, h, p, n, Q, nc = _dims(x_shape, B_shape, chunk)
    per_chunk = Q * n * Q + h * (Q * n * p + n * p + Q * Q * p + Q * n * p)
    return 2 * b * nc * per_chunk


def workspace_bytes(x_shape, B_shape, chunk: int) -> int:
    """Bytes of the kernel's workspaces: cb (b,nc,Q,Q) f32, cum
    (b,nc,h,Q) f64, states (b,nc,h,n,p) f32."""
    b, s, h, p, n, Q, nc = _dims(x_shape, B_shape, chunk)
    return 4 * b * nc * Q * Q + 8 * b * nc * h * Q + 4 * b * nc * h * n * p


def register_sharding_rule() -> None:
    """Tell DTensor how the op shards: replicated, on batch (x, dt, B, C,
    the state and both outputs on dim 0), or on heads (x, dt on dim 2, A
    on 0, the state on 1; B and C replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.ssd_scan.default)
    def _rule(x, dt, A, B, C, chunk, initial_state):
        def h0(p):
            return None if initial_state is None else p
        R = Replicate()
        out = [([R, R], [R, R, R, R, R, None, h0(R)]),
               ([Shard(0), Shard(0)],
                [Shard(0), Shard(0), R, Shard(0), Shard(0), None,
                 h0(Shard(0))])]
        if x.shape[2] % max(x.mesh.shape) == 0:
            out.append(([Shard(2), Shard(1)],
                        [Shard(2), Shard(2), Shard(0), R, R, None,
                         h0(Shard(1))]))
        return out


def ssd_scan(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """x: (b,s,h,p), dt: (b,s,h), A: (h,), B/C: (b,s,n) -> (y (b,s,h,p),
    final state (b,h,n,p) f32)."""
    if not on_cuda(x):
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    no_backward("ssd_scan", x, dt, A, B, C, initial_state)
    if type(x) is torch.Tensor:
        return ssd_scan_kernel(x, dt, A, B, C, chunk, initial_state)
    cdt = x.dtype if x.dtype == B.dtype == C.dtype \
        and x.dtype in _KERNEL_DTYPES else F32
    h0 = None if initial_state is None \
        else initial_state.to(F32).contiguous()
    y, final = torch.ops.repro_torch.ssd_scan(
        x.to(cdt).contiguous(), dt.to(F32).contiguous(),
        A.to(F32).contiguous(), B.to(cdt).contiguous(),
        C.to(cdt).contiguous(), chunk, h0)
    return y.to(x.dtype), final


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    return ssd_scan(x, dt, A, B, C, chunk)[0]
