"""Share of the traced window in which the device was idle while the host
was inside the engine's ``segment`` and neither in the client block nor
in the DP clip and noise: the tick's integer phase, its host read, the
server step, deliver, the ring scatter, and between ticks.  With
``idle_in_client_block``, ``idle_in_noise`` and the idle time under no
program span (the window's edges) it adds up to ``device_idle_share``."""
from fedbench import program_spans

UNIT = "%"
PROBES = ("profiler",)
install = program_spans.install


def read(ctx):
    split = program_spans.idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split["tick_host"] / (ctx["trace"].window_s * 1e9)
