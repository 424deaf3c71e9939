"""Share of the traced window in which the device was idle while the
innermost program span open on the host was the client block
(``client_block`` or a child of it: the model path's clone, batch draw,
loss and gradient, update and write-back).  ``fedbench/program_spans.py``
puts each idle nanosecond of the device trace under the span open over
it."""
from fedbench import program_spans

UNIT = "%"
PROBES = ("profiler",)
install = program_spans.install


def read(ctx):
    split = program_spans.idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split["client_block"] / (ctx["trace"].window_s * 1e9)
