"""What the traced run records, from the benchmark's side of the program.

Per-layer metrics name the probes they read (``PROBES`` in their
module); the harness opens those probes around the measured window:

* ``spans``: CUDA events recorded on the stream around each call of the
  client block (``ltask.run_block``) and of the round's clip and noise
  (``_clip_noise``), with no host sync, and the host's wall-clock range
  of those calls and of the server step, so the idle gaps of the device
  trace can be named by what the host was doing;
* ``launches``: the arguments of each launch of the engine kernels (rows
  delivered, rows done, ring rows, block partials) as device scalars,
  read once the window has closed;
* ``profiler``: ``torch.profiler`` over the window, device activity
  only (recording every host operation as well doubled the host's time
  a step of the model cell), kept in memory.

A metric that needs another probe defines ``install(engine, ctx)`` in its
own module, returning a function that removes it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import torch

#: the host ranges the harness records and what they stand for
RANGES = {"segment": "segment loop: integer phase and host",
          "client_block": "client block", "clip_noise": "DP clip and noise",
          "server_step": "server step"}


@contextlib.contextmanager
def host_range(ctx, label: str):
    """Record the host's wall-clock range of the block (the profiler's
    clock) under ``label`` in ``ctx["host_ranges"]``."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        ctx.setdefault("host_ranges", []).append((t0, time.time_ns(), label))


def _patch(obj, name: str, make: Callable) -> Callable[[], None]:
    """Replace ``obj.name`` by ``make(original)``; returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    if isinstance(obj, type) or not hasattr(type(obj), name):
        return lambda: setattr(obj, name, orig)
    return lambda: delattr(obj, name)     # the instance attribute goes


def install_spans(engine, ctx) -> Callable[[], None]:
    from repro_torch.cohort import device as devmod
    spans: Dict[str, List] = ctx.setdefault("spans", {})

    def timed(label: str):
        def make(fn):
            def wrapper(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                with host_range(ctx, label):
                    e0.record()
                    out = fn(*a, **k)
                    e1.record()
                spans.setdefault(label, []).append((e0, e1))
                return out
            return wrapper
        return make

    def ranged(fn):
        def wrapper(*a, **k):
            with host_range(ctx, "server_step"):
                return fn(*a, **k)
        return wrapper

    undo = [_patch(engine.ltask, "run_block", timed("client_block")),
            _patch(engine, "_clip_noise", timed("clip_noise")),
            _patch(devmod, "server_apply", ranged)]
    return lambda: [u() for u in reversed(undo)]


def install_launches(engine, ctx) -> Callable[[], None]:
    """Each engine kernel's launch as (kernel, arguments), device scalars
    left on the device."""
    from repro_torch.cohort import clients as climod
    from repro_torch.cohort import device as devmod
    rec: List = ctx.setdefault("launches", [])

    def on(kernel: str, args_of):
        def make(fn):
            def wrapper(*a, **k):
                out = fn(*a, **k)
                rec.append((kernel, args_of(out, *a, **k)))
                return out
            return wrapper
        return make

    def server(out, v, due, dec, has_arr, **k):
        fired = k.get("fired")
        nf = (fired.sum() if k.get("bc_v") is not None
              else torch.zeros((), dtype=torch.int64, device=v.device))
        return dict(D=v.shape[0], A=due.shape[0], arr=has_arr, fired=nf,
                    hit=(k["ovf_hit"].any() if k.get("ovf") is not None
                         else False),
                    buffered=k.get("buf") is not None,
                    flush=k.get("flush") if k.get("buf") is not None
                    else False)

    def deliver(out, w, U, bc_v, best, take, eta):
        return dict(C=w.shape[0], D=w.shape[1], nt=take.sum())

    def rows(out, sent, w, U, wgt, done, eta, **k):
        return dict(C=sent.shape[0], D=sent.shape[1], G=wgt.shape[0],
                    nd=done.sum(), nblk=out[2].shape[0])

    def finish(out, partial, rows_, any_g):
        return dict(nblk=partial.shape[0], G=partial.shape[1],
                    D=partial.shape[2])

    def noise(out, u, noise_, weights, mask, **k):
        return dict(C=u.shape[0], D=u.shape[1], nd=mask.sum(),
                    clip=k.get("clip", 0.0) > 0.0)

    def noise_prng(out, u, key, weights, mask, **k):
        return dict(C=u.shape[0], D=u.shape[1], nd=mask.sum())

    undo = [_patch(devmod, "server_apply", on("server_apply", server)),
            _patch(devmod, "tick_deliver", on("tick_deliver", deliver)),
            _patch(climod, "tick_scatter_rows", on("tick_scatter_rows", rows)),
            _patch(devmod, "tick_scatter_finish",
                   on("tick_scatter_finish", finish)),
            _patch(devmod, "cohort_clip_noise",
                   on("cohort_clip_noise", noise)),
            _patch(devmod, "cohort_clip_noise_prng",
                   on("cohort_clip_noise_prng", noise_prng))]
    return lambda: [u() for u in reversed(undo)]


PROBES = {"spans": install_spans, "launches": install_launches}


@contextlib.contextmanager
def profiled(on: bool, ctx):
    """torch.profiler over the block when ``on``; its kineto events go to
    ``ctx["trace_events"]``."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    ctx["trace_events"] = prof.profiler.kineto_results.events()


def span_seconds(ctx, label: str) -> float:
    """Seconds of device time between each pair of a span's events."""
    return sum(a.elapsed_time(b) for a, b in ctx.get("spans", {})
               .get(label, ())) / 1e3
