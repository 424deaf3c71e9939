"""Dispatch for the SSD scan kernel: by the tensors' device.

A CUDA tensor goes to the CUDA kernel or the call raises; a CPU tensor
goes to the plain version (``ssd_chunked``).  The kernels have no
backward: on the card an input that requires grad, in grad mode,
raises.  ``ssd_scan`` returns ``(y, final_state)``, the contract of
``apply_ssm``'s ``ssd_fn`` hook; ``ssd`` returns ``y`` alone, as the
reference's ``ops.ssd``.
"""
from __future__ import annotations

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.kernels.tick_fused.ops import no_backward, on_cuda


def ssd_scan(x, dt, A, B, C, chunk: int = 128, initial_state=None):
    """x: (b,s,h,p), dt: (b,s,h), A: (h,), B/C: (b,s,n) -> (y (b,s,h,p),
    final state (b,h,n,p) f32)."""
    if not on_cuda(x):
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    no_backward("ssd_scan", x, dt, A, B, C, initial_state)
    return ssd_scan_kernel(x, dt, A, B, C, chunk, initial_state)


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    return ssd_scan(x, dt, A, B, C, chunk)[0]
