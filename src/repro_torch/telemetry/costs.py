"""In-loop op-census: per-segment cost attribution for the tick engines.

The census counters say *what* the protocol did (messages, broadcasts,
staleness); the op census says *which tick-loop operations did it*, so
a run's wall time can be decomposed into cost per op.

The counters live on the device as one ``[N_OPS]`` int32 vector on
``DeviceCohortState`` (``ops``), advanced by the tick's integer phase
only, so they never perturb the float math.  They are exact against
the JAX reference engine.

Counter semantics (all cumulative over the run):

  ``ticks``            protocol ticks executed
  ``block_ticks``      ticks where >= 1 client ran block iterations
                       (the ``run_block``/``nmax > 0`` gate)
  ``bucket_applies``   ticks whose arrival bucket was non-empty (the
                       server's ``v -= bucket`` apply ran)
  ``cascade_ticks``    ticks where the broadcast cascade fired (the
                       server's completed-round counter advanced)
  ``deliver_ticks``    ticks where >= 1 client's freshest-seen k
                       advanced (the [C, D] ISRRECEIVE gather ran)
  ``deliver_rows``     clients whose freshest-seen k advanced, summed
                       over ticks (rows the delivery gather replaced)
  ``ring_scatters``    distinct near-tier ring slots scattered into by
                       finishing cohorts (the unrolled per-slot
                       masked-sum writes that actually ran)
  ``complete_ticks``   ticks where >= 1 round completed (``do_complete``
                       branch hits)
  ``far_ticks``        completion ticks that routed >= 1 update to the
                       far tier (``do_far`` branch hits)
  ``far_groups``       distinct far arrival-tick groups inserted into
                       the overflow bucket

Relations the trace checker enforces (rule INV-SPAN, see
``repro.analysis.invariants``): tick-gated counters are bounded by
``ticks``; ``complete_ticks <= messages``; ``ring_scatters <=
messages - far_messages``; ``far_ticks <= far_groups <=
far_messages``; ``bucket_applies <= ring_scatters + far_groups``;
``cascade_ticks <= broadcasts``; ``deliver_rows <= broadcasts * C``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

#: op-census counter names, in vector order (index = position)
OP_NAMES = (
    "ticks",
    "block_ticks",
    "bucket_applies",
    "cascade_ticks",
    "deliver_ticks",
    "deliver_rows",
    "ring_scatters",
    "complete_ticks",
    "far_ticks",
    "far_groups",
)
N_OPS = len(OP_NAMES)

# index constants (used by both engines' increment sites)
OP_TICKS = OP_NAMES.index("ticks")
OP_BLOCK_TICKS = OP_NAMES.index("block_ticks")
OP_BUCKET_APPLIES = OP_NAMES.index("bucket_applies")
OP_CASCADE_TICKS = OP_NAMES.index("cascade_ticks")
OP_DELIVER_TICKS = OP_NAMES.index("deliver_ticks")
OP_DELIVER_ROWS = OP_NAMES.index("deliver_rows")
OP_RING_SCATTERS = OP_NAMES.index("ring_scatters")
OP_COMPLETE_TICKS = OP_NAMES.index("complete_ticks")
OP_FAR_TICKS = OP_NAMES.index("far_ticks")
OP_FAR_GROUPS = OP_NAMES.index("far_groups")

#: counters incremented at most once per tick — each is bounded by
#: ``ticks`` (INV-SPAN uses this split)
TICK_GATED = ("block_ticks", "bucket_applies", "cascade_ticks",
              "deliver_ticks", "complete_ticks", "far_ticks")


def zero_ops() -> np.ndarray:
    """Host-side zero op-census vector (int64 accumulator)."""
    return np.zeros(N_OPS, dtype=np.int64)


def ops_dict(ops: Union[Sequence[int], np.ndarray, None]
             ) -> Optional[Dict[str, int]]:
    """[N_OPS] vector -> name-keyed dict (None passes through)."""
    if ops is None:
        return None
    vals = [int(x) for x in np.asarray(ops).reshape(-1)]
    if len(vals) != N_OPS:
        raise ValueError(
            f"op-census vector has {len(vals)} entries, want {N_OPS} "
            f"({', '.join(OP_NAMES)})")
    return dict(zip(OP_NAMES, vals))


def ops_vector(ops: Optional[Mapping[str, int]]) -> np.ndarray:
    """Name-keyed dict -> [N_OPS] int64 vector (unknown keys rejected)."""
    out = zero_ops()
    if ops:
        for name, val in ops.items():
            if name not in OP_NAMES:
                raise ValueError(f"unknown op-census counter {name!r}")
            out[OP_NAMES.index(name)] = int(val)
    return out


def cost_decomposition(ops: Mapping[str, int], *,
                       steady_s: Optional[float] = None,
                       ticks: Optional[int] = None,
                       loop_iters: Optional[int] = None,
                       block_iters: Optional[int] = None
                       ) -> Dict[str, float]:
    """Per-op share of a steady-state run, for BENCH_cohort.json.

    With ``steady_s`` given, adds ``s_per_tick`` (amortized wall seconds
    per protocol tick) so entries can be compared across workloads; the
    ``tick_overhead_ratio`` is the roofline item's number.  Without the
    iteration census it is the fraction of ticks that did protocol-only
    work (no client compute block ran).  When the device engine's tick
    coalescing is on, overhead ticks ride along inside compute
    iterations, so what the roofline actually pays is while_loop
    ITERATIONS — pass ``loop_iters`` / ``block_iters``
    (``DeviceCohortEngine.fused_iters``) and the ratio becomes the
    fraction of loop iterations that ran without a compute block,
    alongside ``ticks_per_iter`` (how many protocol ticks one iteration
    amortizes, in [1, 2]).
    """
    t = int(ticks if ticks is not None else ops.get("ticks", 0))
    out: Dict[str, float] = {}
    if t > 0:
        for name in OP_NAMES:
            out[f"{name}_per_tick"] = ops.get(name, 0) / t
        out["tick_overhead_ratio"] = 1.0 - ops.get("block_ticks", 0) / t
        if steady_s is not None:
            out["s_per_tick"] = float(steady_s) / t
        if loop_iters is not None and int(loop_iters) > 0:
            li = int(loop_iters)
            out["loop_iters"] = float(li)
            out["ticks_per_iter"] = t / li
            out["tick_overhead_ratio"] = 1.0 - int(block_iters or 0) / li
    return out


def check_ops(ops: Mapping[str, int], *,
              messages: Optional[int] = None,
              broadcasts: Optional[int] = None,
              far_messages: Optional[int] = None,
              clients: Optional[int] = None,
              ticks: Optional[int] = None,
              loop_iters: Optional[int] = None,
              block_iters: Optional[int] = None) -> List[str]:
    """Internal-consistency relations of one op-census dict.

    Returns human-readable problem strings; the trace checker wraps
    them as INV-SPAN violations.  Only relations whose inputs are
    provided are checked.
    """
    problems: List[str] = []
    get = lambda k: int(ops.get(k, 0))  # noqa: E731
    for name in OP_NAMES:
        if get(name) < 0:
            problems.append(f"op counter {name} is negative: {get(name)}")
    t = int(ticks) if ticks is not None else get("ticks")
    for name in TICK_GATED:
        if get(name) > t:
            problems.append(
                f"tick-gated op counter {name}={get(name)} exceeds "
                f"ticks={t}")
    if ticks is not None and get("ticks") != int(ticks):
        problems.append(
            f"op counter ticks={get('ticks')} != report ticks={ticks}")
    if messages is not None:
        if get("complete_ticks") > int(messages):
            problems.append(
                f"complete_ticks={get('complete_ticks')} exceeds "
                f"messages={messages} (a completion tick sends >= 1)")
        near = int(messages) - int(far_messages or 0)
        if get("ring_scatters") > near:
            problems.append(
                f"ring_scatters={get('ring_scatters')} exceeds near-tier "
                f"messages={near} (a scatter needs >= 1 near arrival)")
        if get("bucket_applies") > (get("ring_scatters")
                                    + get("far_groups")):
            problems.append(
                f"bucket_applies={get('bucket_applies')} exceeds "
                f"ring_scatters + far_groups = "
                f"{get('ring_scatters') + get('far_groups')} (an applied "
                f"bucket comes from >= 1 insert)")
    if far_messages is not None:
        if get("far_groups") > int(far_messages):
            problems.append(
                f"far_groups={get('far_groups')} exceeds "
                f"far_messages={far_messages}")
        if get("far_ticks") > get("far_groups"):
            problems.append(
                f"far_ticks={get('far_ticks')} exceeds "
                f"far_groups={get('far_groups')}")
    if broadcasts is not None:
        if get("cascade_ticks") > int(broadcasts):
            problems.append(
                f"cascade_ticks={get('cascade_ticks')} exceeds "
                f"broadcasts={broadcasts} (a cascade tick fires >= 1)")
        if clients is not None and get("deliver_rows") > \
                int(broadcasts) * int(clients):
            problems.append(
                f"deliver_rows={get('deliver_rows')} exceeds "
                f"broadcasts * clients = {int(broadcasts) * int(clients)}"
                f" (a client advances k at most once per broadcast)")
    if get("deliver_ticks") > get("deliver_rows"):
        problems.append(
            f"deliver_ticks={get('deliver_ticks')} exceeds "
            f"deliver_rows={get('deliver_rows')}")
    if loop_iters is not None:
        li, bi = int(loop_iters), int(block_iters or 0)
        # tick coalescing merges at most two ticks per iteration, and
        # an iteration holds at most one block tick
        if not bi <= li <= t <= 2 * li:
            problems.append(
                f"iteration census violates block_iters <= loop_iters "
                f"<= ticks <= 2 * loop_iters: ({bi}, {li}, {t})")
        if get("block_ticks") < bi:
            problems.append(
                f"block_iters={bi} exceeds block_ticks="
                f"{get('block_ticks')} (an iteration's block came from "
                f">= 1 block tick)")
    return problems
