"""Fused device-tick kernels: the server step, delivery gather, ring
scatter.

CUDA kernels over the [C, D] client block (``csrc/tick_fused.cu``,
launched by ``kernel.py``) with plain PyTorch versions (``ref.py``;
``tick_scatter_twin`` also repeats the kernel's add order, so on the CPU
it gives the kernel's bits, and so do the twins of its two passes,
``tick_scatter_rows_twin`` and ``tick_scatter_finish_twin``); ``ops.py``
dispatches by the tensors' device.
"""
from repro_torch.kernels.tick_fused.ops import (bucket_apply,
                                                scatter_partition,
                                                server_apply, tick_deliver,
                                                tick_scatter,
                                                tick_scatter_finish,
                                                tick_scatter_rows)
from repro_torch.kernels.tick_fused.ref import (bucket_apply_ref,
                                                server_apply_ref,
                                                tick_deliver_ref,
                                                tick_scatter_finish_twin,
                                                tick_scatter_ref,
                                                tick_scatter_rows_twin,
                                                tick_scatter_twin)

__all__ = [
    "bucket_apply", "server_apply", "tick_deliver", "tick_scatter",
    "tick_scatter_rows", "tick_scatter_finish", "scatter_partition",
    "bucket_apply_ref", "server_apply_ref", "tick_deliver_ref",
    "tick_scatter_ref",
    "tick_scatter_twin", "tick_scatter_rows_twin",
    "tick_scatter_finish_twin",
]
