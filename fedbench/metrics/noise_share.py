"""Share of the window's wall in the round's DP clip and noise (the
engine's ``_clip_noise``: the operand draw and ``cohort_clip_noise``, or
``cohort_clip_noise_prng``): CUDA events around each call, summed."""
from fedbench.probes import span_seconds

UNIT = "%"
PROBES = ("spans",)


def read(ctx):
    s = span_seconds(ctx, "clip_noise")
    return 100.0 * s / ctx["wall_s"] if s > 0 else None
