"""Share of the client block's device time outside the model's loss and
gradient: 1 - (the device time of the program's ``loss_and_grad`` spans)
/ (that of its ``client_block`` spans), each span's device time between
two CUDA events recorded on the stream at its edges.  What is left is
the flat adapter's: the clones of the blocks, the batch draws, the
updates and the write-backs."""
from fedbench import program_spans

UNIT = "%"
PROBES = ()
install = program_spans.install


def read(ctx):
    block = sum(s.get("device_s", 0.0)
                for s in program_spans.spans_named(ctx, "client_block"))
    model = sum(s.get("device_s", 0.0)
                for s in program_spans.spans_named(ctx, "loss_and_grad"))
    return 100.0 * (1.0 - model / block) if block > 0 and model > 0 else None
