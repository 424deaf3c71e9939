"""Host reads of the segment loop a tick: the engine's own count of its
syncs (one a tick, one a segment call) over the ticks of the window."""
UNIT = "syncs/tick"
PROBES = ()


def read(ctx):
    ticks = ctx["census"]["ticks"]
    return ctx["host_syncs"] / ticks if ticks else None
