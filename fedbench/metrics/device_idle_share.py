"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window."""
UNIT = "%"
PROBES = ("profiler",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
