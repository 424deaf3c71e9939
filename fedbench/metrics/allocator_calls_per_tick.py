"""The caching allocator's device allocations and frees (``cudaMalloc``,
``cudaFree``) a tick: the deltas of ``torch.cuda.memory_stats``'
``num_device_alloc`` and ``num_device_free`` that the program records
over each ``tick`` span of the window, summed, over the ticks."""
from fedbench import program_spans

UNIT = "calls/tick"
PROBES = ()
install = program_spans.install


def read(ctx):
    ticks = program_spans.spans_named(ctx, "tick")
    if not ticks:
        return None
    calls = sum(s["counters"].get(k, 0) for s in ticks
                for k in ("num_device_alloc", "num_device_free"))
    return calls / len(ticks)
