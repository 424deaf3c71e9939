"""The engine kernels' share of their roofline: the sum of each launch's
bound (``fedbench/counts/kernels.py``, on the launch's own arguments)
over the sum of their device times in the trace (``server_apply``,
``tick_deliver``, tick_scatter's rows and finish passes and the clip and
noise kernel).  Launches and device times are both of the whole traced
window."""
from fedbench.counts import kernels as K

UNIT = "%"
PROBES = ("launches", "profiler")

# each launcher's kernels, as the device trace names them
KERNELS = {
    "server_apply": r"server_apply_kernel",
    "tick_deliver": r"tick_deliver_kernel",
    "tick_scatter_rows": r"tick_scatter_rows_kernel",
    "tick_scatter_finish": r"(?<![a-z_])finish_kernel",
    "cohort_clip_noise": r"row_scale_kernel|clip_noise_elts_kernel",
    "cohort_clip_noise_prng": r"row_scale_kernel|clip_noise_elts_kernel",
}


def _bound(kernel, a):
    if kernel == "server_apply":
        return K.server_bound(a["D"], a["A"], arr=bool(a["arr"]),
                              fired=int(a["fired"]), hit=bool(a["hit"]),
                              buffered=a["buffered"], flush=bool(a["flush"]))
    if kernel == "tick_deliver":
        return K.deliver_bound(a["C"], a["D"], int(a["nt"]))
    if kernel == "tick_scatter_rows":
        return K.rows_bound(a["C"], a["D"], a["G"], int(a["nd"]), a["nblk"])
    if kernel == "tick_scatter_finish":
        return K.finish_bound(a["nblk"], a["G"], a["D"])
    if kernel == "cohort_clip_noise":
        return K.noise_bound(a["C"], a["D"], int(a["nd"]), clip=a["clip"])
    return K.noise_prng_bound(a["C"], a["D"], int(a["nd"]))


def read(ctx):
    tr, launches = ctx.get("trace"), ctx.get("launches_host")
    if tr is None or not launches:
        return None
    bound_s = sum(_bound(k, a) for k, a in launches)
    names = sorted({KERNELS[k] for k, _ in launches})
    dev_s = tr.seconds_matching("|".join(f"(?:{n})" for n in names))
    return 100.0 * bound_s / dev_s if dev_s > 0 else None
