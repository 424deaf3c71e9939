"""The device cohort engine's state at the window's end: the bytes of
every tensor field of ``DeviceCohortState``, in GiB."""
UNIT = "GiB"
PROBES = ()


def read(ctx):
    st = ctx["state"]
    return sum(t.numel() * t.element_size() for t in st) / 2 ** 30
