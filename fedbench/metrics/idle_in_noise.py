"""Share of the traced window in which the device was idle while the
innermost program span open on the host was the round's DP clip and
noise (``clip_noise``, its ``noise_draw`` and ``clip_noise_kernel``)."""
from fedbench import program_spans

UNIT = "%"
PROBES = ("profiler",)
install = program_spans.install


def read(ctx):
    split = program_spans.idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split["noise"] / (ctx["trace"].window_s * 1e9)
