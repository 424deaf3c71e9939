"""Useful local steps over executed ones: the client block runs
``b_stat`` iterations for every client on every block tick and masks the
ones a client has no credit or round left for."""
UNIT = "%"
PROBES = ()


def read(ctx):
    ex = ctx["executed_steps"]
    return 100.0 * ctx["useful_steps"] / ex if ex else None
