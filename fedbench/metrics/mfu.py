"""The whole step's share of the chip's f32 peak: model flops of the
local steps completed in the window (``fedbench/counts/models.py``; no
masked step and no recomputation counted) over the window's wall, against
67 Tflop/s (f32 outside the tensor cores: the program computes in f32
with TF32 off)."""
from fedbench.counts.kernels import F32_FLOPS

UNIT = "%"
PROBES = ()


def read(ctx):
    flops = ctx["useful_steps"] * ctx["flops_per_step"]
    return 100.0 * flops / ctx["wall_s"] / F32_FLOPS if flops else None
