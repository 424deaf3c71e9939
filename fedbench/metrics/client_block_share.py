"""Share of the window's wall in the client block: CUDA events recorded
on the stream around each call of the task's ``run_block``, summed."""
from fedbench.probes import span_seconds

UNIT = "%"
PROBES = ("spans",)


def read(ctx):
    s = span_seconds(ctx, "client_block")
    return 100.0 * s / ctx["wall_s"] if s > 0 else None
