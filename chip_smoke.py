#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and runs:

0. ``server_step`` (first: a later profiler session of one process may
   lose events): the main run and both scenario runs (at most
   ``SERVER_TICKS`` ticks each) with each server step's operands recorded,
   each step replayed through the kernel and through the separate-launch
   route (v' and every row bit for bit alike), the device operations a tick
   of each route counted with ``torch.profiler`` by tick kind, one session
   a run with probe kernels between the steps, discarded and run again
   where it lost a probe (the kernel's count must be 1);
1. every kernel against its plain PyTorch version at the shapes of the
   main run (bitwise where the kernel keeps the plain version's
   rounding, within a stated tolerance where it reorders a sum), twice
   for identical bits, with its median time (CUDA graph of launches,
   CUDA events), its bound and the plain version's time; the clip+noise
   kernels with and without their weighted sum (agg), the in-kernel one
   at no, half and all rows masked with signed zeros in pass-through
   rows;
   also ``bucket_apply`` at FedAsync's ``A = R`` with decay weights and
   ``tick_scatter`` at its ``G = L * R``, and the in-kernel noise's
   counter stream bit for bit; row 1 as the server's whole step of a
   tick (``server_apply``, one launch) bit for bit its twin on v' and
   every row it writes in place, in every case of the CPU test, with the
   10-call graph time of the main run's and the scenarios' ticks beside
   the separate-launch route's; ``tick_scatter`` (and, in phase 6,
   ``clip_accumulate``) also bit for bit against its order-exact twin,
   with the time of each of its passes (``torch.profiler``), its ptxas
   report (a spill fails) and a planted fault, one block's partial left
   out of the finish pass, that SUM_RTOL must catch;
2. the FedSGD census case (C = 4096), whose integer op census must
   reproduce the reference's, and a small DP case that must agree with
   the port's plain CPU run;
3. the main run: the paper's DP configuration (Fig. 1b sizes and step
   sizes, sigma = 8, clip 0.1) on MNIST-width logistic regression
   (D = 785) over C = 16384 clients, with every kernel's launch count,
   then the same with the noise generated in the kernel; then the
   client block's kernel (``cohort_logreg_block``) bit for bit against
   its twin on one of the main run's own block ticks (its n, i, h,
   step sizes, clip and l2; the run's last rows), with its time, its
   bound and the twin's time;
4. the scenarios: the same configuration under ``mobile_diurnal`` with
   FedAsync and under ``iot_straggler`` with FedBuff and a ring of 2
   ticks (updates spill into the overflow bucket), in-kernel noise
   (with the masked share of each noise launch), each repeated with
   operand noise (identical integer state);
5. a small stratified + overflow + DP case on the card against the
   port's plain CPU run, with both noise sources;
6. the model-scale kernels (``clip_accumulate``, ``flash_attention``,
   ``ssd_scan``) against their plain versions at the shapes of the three
   paths below (``clip_accumulate`` at the DP round's N = 60000 and its
   microbatch's 6000, f32 and bf16) and at ragged edge shapes (the f32 attention kernel's and
   the chunk-parallel SSD's tile edges among them), f32 and bf16; the
   ptxas report of both attention kernels (the f32 one at hd 256 may not
   spill) and of the four SSD kernels; for the bf16 ``flash_attention``
   (tensor cores) also the count of HGMMA instructions in the library
   (none fails), its edge shapes and its time against the tensor cores'
   bound; planted faults that the limits must catch (a dropped kv tile
   in bf16 attention, the carry dropped from the SSD's last chunk);
7. ``dp_round``: the example-level DP-SGD round (``dp_sgd_round``) on
   the main run's data (D = 785) with its DP knobs, whole and in 10
   microbatches, card against CPU;
8. ``attention_layer``: one gemma2-2b attention layer at full width
   (local and global, f32 and bf16, S = 8192), through the kernel
   against the reference's dense core on the card;
9. ``ssm_layer``: one mamba2-780m mixer at full width (B = 4, S =
   2048), through the kernel against the plain chunked SSD on the card,
   with and without the final state; its warm wall through the kernel
   must be below its wall through the plain SSD;
10. ``host_engine``: the host-loop cohort engine (``CohortSimulator``)
   at the main run's configuration, then under phase 4's two scenarios
   for one round each, each bit for bit against the device engine with
   operand noise (the model, the eval losses, ``w``/``U``/``v``, the
   integer state and the op census), with its wall, ms per tick and
   kernel launches (counts zeroed before each host run, read after; one
   server-step launch per apply);
11. ``event``: the discrete-event simulator at D = 785 over C = 64
   clients (the main run's data; the population is cut, the engine
   being per-client Python) in the three-way-parity configuration (d =
   1, a ``sample_seed`` task, sizes [10, 20, 30, 40], 4 rounds): its
   integers equal both cohort engines', its model within 1e-4 of
   theirs, the cohort engines bit for bit; and against its own CPU run;
12. ``model_serve``: the model API at full width and depth, weights from
   ``init_params``: gemma2-2b (26 layers, vocab 256000) f32 and bf16 at B
   1, S 8192 through ``flash_attention`` and mamba2-780m (48 layers) f32
   at B 4, S 2048 through ``ssd_scan``, ``forward_prefill`` three times
   each (one launch a layer), against the same models through the plain
   cores on the card, layer by layer (phases 8's and 9's limits) and end
   to end (logits, final hidden states); the serve path (f32):
   ``prefill_into_cache`` over a 32-token prompt and 16 greedy decode
   steps, its prompt logits against the kernels' prefill pass; then
   ``python -m repro_torch.launch.serve`` for both archs, as users start
   it (exit 0).  Peak memory per model;
13. ``model_train``: (a) one ``BatchModelTask`` step of gemma2-2b at full
   width (f32, B 1, S 1024) through the plain cores under autograd with
   remat (each layer body and loss chunk checkpointed, the default) and
   without, loss and every gradient bit for bit between the two, its
   loss against the kernels' route, U the step's gradient and w = w0 -
   eta U bit for bit, with both walls and peaks and a warm gradient pass
   of each with the attention cores' share (CUDA events in autograd
   hooks: the first pass's forward and each call's backward, the remat
   reruns timed apart); (b) mamba2-780m (``TRAIN_COHORT``): one round of
   the device engine with DP at its 48 layers (D ~ 7.8e8) to see whether
   its hungriest run fits the card, then, at 48 layers or at
   ``cut_layers``, three rounds on
   the device engine without DP (with remat and without, bit for bit),
   with operand noise and with in-kernel noise, the host engine bit for
   bit against the first and the operand one, the event simulator
   against the first (integers exact, ``EVENT_*_ATOL``), the engine's
   reckoned rows and the reckoning at 48 layers beside the peak memory,
   one server-step launch a tick (device) or an apply
   (host); then rows 1-5 at that D against their plain versions slab by
   slab, each timed and bounded (row 1 as the server step, with and
   without a fired broadcast row, beside the separate-launch route); (c)
   ``python -m repro_torch.launch.train`` at full width with a checkpoint
   that loads back through ``load_fl_state``, and reduced with DP;
14. ``trace``: (a) the main run with ``trace=`` a JSONL file, once per
   noise source (rows 1-5 launched), each run's records and wall spans
   made one Perfetto document as ``python -m repro_torch.telemetry``
   makes it, with zero findings from ``validate_trace_events``,
   ``check_perfetto``, ``check_trace`` (d = 2) and ``check_report``;
   (b) a regression planted in a copy of each run's records (the last
   segment's ``messages`` and ``staleness_hist[0]`` below the previous
   segment's) that the checker must report as INV-MONO (and INV-LATCH
   where the overflow mark was above 0); (c) the event simulator at
   phase 11's C = 64, traced, clean at its d; (d) ``python -m
   repro_torch.telemetry capture`` (device engine, ``mobile_diurnal``,
   DP) and ``convert``, and ``python -m repro_torch.analysis
   src/repro_torch`` (PRNG-*, PURITY-*, STRUCT-*: 0 findings), as users
   start them (exit 0, valid output); (e) a
   main run with its spans annotated under ``torch.profiler`` (CPU and
   CUDA activities): every span name among the profiler's events, and
   the CUDA time the profiler puts inside them; (f) the main run's wall
   with and without ``trace=`` (3 each after a warm-up, medians), and
   the time of the report record's emit alone;
15. ``dryrun``: (a) ``python -m repro_torch.launch.dryrun`` for gemma2-2b
   and mamba2-780m over the four input shapes on both fake production
   meshes (16 processes, 8 at once): exit 0, no FAIL row, SKIP only where
   ``shape_is_applicable`` skips, every field of the reference's rows,
   ``corrected_costs`` equal to the full-depth count; gemma2-2b
   ``train_4k``'s planned temp with remat beside the plan without it;
   then ``python -m repro_torch.launch.report``; (b) the dry run's accounting against the
   card at full width and 2 layers (``DRYRUN_CHECK``): each step traced on
   a fake one-rank mesh and run for real on a one-rank NCCL mesh, argument
   bytes and flops (``FlopCounterMode``) equal, no collective in either,
   the predicted peak within ``DRYRUN_PEAK_RTOL`` of
   ``max_memory_allocated`` above the arguments, the wall at least
   ``DRYRUN_WALL_FLOOR`` of the roofline's bound; (c) the kernels' custom
   ops bit for bit the launchers at phase 12's shapes, their fake
   implementations' shape, dtype and stride the real outputs'; (d) STRUCT-*
   on a device state on the card (no finding), and planted spec faults
   read as STRUCT-PSPEC and STRUCT-STALE.  Prints its own kernels line
   (``{"phase": "dryrun", "kernels": [...]}``: rows 7 and 8 through their
   custom ops, launches from (b)'s real runs).
16. ``cohort_mesh`` (run right after phase 10): the device engine over a
   ``clients`` mesh of one NCCL rank: (a) the main run with operand and
   with in-kernel noise, bit for bit phase 3's ``mesh=None`` runs (the
   integers, the census, the losses as bytes, ``w`` / ``U`` / ``v``), the
   state's placements ``cohort_shardings``' (views of the rank's
   tensors), one host read a tick and the collectives a tick printed;
   (b) phase 5's small overflow + FedAsync case, bit for bit its
   ``mesh=None`` run, both noise sources; meanwhile the five ported
   examples (``examples/torch_*.py``) at their reference sizes on the
   card, all started at once as users start them (exit 0, each one's
   wall printed).  Phase 1 (c) holds tick_scatter's two entry points
   (``tick_scatter_rows``, ``tick_scatter_finish``: the engines' route)
   to the fused launch and their twins at the main shape, a rank's rows
   at a row offset from a carry among them, and the in-kernel noise at
   a row offset to the whole draw's rows.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
(launches from the path that runs each kernel most: the tick kernels'
from the scenario runs, with the main run's and the host engine's beside
them; the fused ``tick_scatter`` is on no path now, ``on_path`` false,
its two passes launched by the engines as ``tick_scatter_rows`` /
``tick_scatter_finish``; attention and the SSD from phase 12, the
one-layer phases' beside them; rows 1-5 also with phase 13's launches and time at model D and
phase 14's traced main runs' launches), and, last,
``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line; so does a machine without CUDA.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W; the int32
# rate, non-tensor, from the Hopper architecture white paper)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
INT32_OPS = 33.5e12
# int32 operations of one element of the in-kernel noise that needs its
# normal (an element of a masked row; a pass-through element is a copy):
# threefry2x32 (2 key adds, 20 rounds of add + rotate (shift, shift, or)
# + xor, 5 key injections of 3 adds) and the two shifts that take the top
# 24 bits
PRNG_INT_OPS = 2 + 20 * 5 + 5 * 3 + 2
# f32 operations of that element: Box-Muller (u1: mul + add; u2: mul;
# -2 log u1: log + mul; sqrt; 2 pi u2: mul; cos; the product) and the
# clip + noise + weighted-sum tile math (4 mul + 2 add)
PRNG_F32_OPS = 10 + 6

# the main run: paper_logreg at its source's widest width (MNIST, 784
# features) with Fig. 1b's DP protocol
MAIN = dict(n=60_000, d=784, C=16_384, d_gate=2, rounds=8, block=64,
            seed=0)
# the scenario runs: the main configuration under two presets, depth
# cut to keep each run (and its operand-noise repeat) near a minute.
# iot_straggler's largest latency bin is 1.84 s (its Pareto table's
# upper edge, q 0.99, is 4.6 s), so only a tick shorter than that (dt =
# block = 1 s) sends updates past a 2-tick ring into the overflow bucket
SCENARIOS = (
    dict(tag="mobile_diurnal+fedasync", scenario="mobile_diurnal",
         strategy=("fedasync", {}), block=4, ring_cap=None, rounds=8),
    dict(tag="iot_straggler+fedbuff", scenario="iot_straggler",
         strategy=("fedbuff", {"buffer_size": 4}), block=1, ring_cap=2,
         rounds=1),
)
# FedSGD census case (benchmarks/bench_cohort_scale.py run_fused_tick,
# C = 4096): op census and iteration census recorded in
# BENCH_cohort.json["fused_tick"]["4096"]["after"]
FEDSGD_C = 4096
FEDSGD_OPS = dict(ticks=16, block_ticks=8, deliver_rows=28672)
FEDSGD_ITERS = (8, 8)

# the model-scale paths: the DP round's microbatch (10 slices of the
# 60000 examples); gemma2-2b's attention layer at its context length;
# mamba2-780m's mixer at Mamba-2's training context, B = 4 giving 192
# (batch, head) blocks.  Depth is cut to one layer; weights come from the
# port's initializers on a seeded key
DP_MICROBATCH = 6000
ATTN = dict(B=1, S=8192)
SSM = dict(B=4, S=2048)
# phase 12, the model API at full width and full depth (gemma2-2b: 26
# layers, vocab 256000; mamba2-780m: 48 layers), weights from
# init_params on a seeded key, at phases 8's and 9's B and S; then the
# serve path over a make_batch prompt at the reference serve driver's
# defaults (batch 4, 32 prompt tokens, 16 generated)
MODEL = (dict(arch="gemma2-2b", kernel="flash_attention", B=1, S=8192,
              dtypes=("float32", "bfloat16")),
         dict(arch="mamba2-780m", kernel="ssd_scan", B=4, S=2048,
              dtypes=("float32",)))
SERVE = dict(batch=4, prompt=32, gen=16)
# the reference suite's tolerances (tests/test_kernels.py): attention
# abs + rel, SSD max error over max |ref|
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# bf16 attention, beside ATTN_TOL: ||out - ref||_2 / ||ref||_2 over the
# whole output and over each output row.  With unit-variance inputs most
# outputs are far below 1, where 2e-2 abs passes nearly anything; the
# sound kernel's rounding (p and the output in bf16) reads about 2e-3
# whole and 4e-3 per row, one 64-key tile dropped from one 128-row q tile
# at S = 8192 about 0.1 per row (the planted fault below)
ATTN_BF16_REL_L2 = 5e-3
ATTN_BF16_ROW_REL_L2 = 2e-2

# phase 12, f32, the model through the kernels against the plain cores on
# the card: max |out - ref| / max |ref| of the last-position logits and
# of the final hidden states.  Phases 8 and 9 read one layer's gap at
# ~1e-6 (attention) and ~2.4e-6 (the SSD mixer); over 48 residual layers
# that adds to ~1.2e-4 at worst, and 2e-4 leaves room over it
MODEL_F32_TOL = 2e-4
# phase 12, bf16, end to end (rel L2 whole and per row): the two cores
# round p differently in every layer and every later op rounds to bf16,
# so the gap compounds with depth; a plain-torch model of the kernel's
# rounding through gemma2-2b's 26 layers at d_model 256, S 512 on the CPU
# reads 2.0e-2 whole and 2.7e-2 in the worst row (tests/test_torch_
# models.py holds it to half these limits).  Each layer's attention
# output, on its own input, is held to phase 8's limits
MODEL_BF16_REL_L2 = 5e-2
MODEL_BF16_ROW_REL_L2 = 1e-1
# the serve path's decode against the prefill pass, f32: the reference
# suite's tolerance for it (tests/test_models_smoke.py,
# test_decode_matches_forward)
DECODE_RTOL, DECODE_ATOL = 2e-2, 2e-3

# phase 13, training at model scale.  (a) One BatchModelTask step of
# gemma2-2b at full width and depth, f32, B 1, S 1024, batches from the
# reference's SeedAddressedBatcher.  (b) mamba2-780m at full width on the
# cohort engines: C 2, d 1, the three-way-parity configuration of the
# reference's model tests (sizes [1, 1, 2], speeds [1.0, 0.8], block 4,
# deterministic latency of 0.05 s, inside one tick), B 2, S 256, three
# rounds; without DP, then with DP (per-step clip 1.0, sigma 8.0) once with
# operand and once with in-kernel noise, and without DP with remat off.
# It runs at the config's 48 layers where one round of the device engine
# with DP (its hungriest run) fits the card, else at ``cut_layers``.
# (c) The train driver as users start it.
TRAIN_STEP = dict(arch="gemma2-2b", B=1, S=1024, eta=0.01)
TRAIN_COHORT = dict(arch="mamba2-780m", cut_layers=32, C=2, d=1,
                    sizes=[[1, 1, 2]] * 2, etas=[0.1, 0.08, 0.06],
                    speeds=[1.0, 0.8], block=4, latency=0.05, B=2, S=256,
                    rounds=3, seed=0, clip=1.0, sigma=8.0)
TRAIN_DRIVER = (["--arch", "mamba2-780m", "--rounds", "3", "--clients", "2",
                 "--batch", "2", "--seq", "256"],
                ["--arch", "gemma2-2b", "--reduced", "--dp"])
# phase 13 (b), f32: the event simulator against the device engine's run
# without DP.  Both run the same steps on the same batches; the server
# applies each update alone in the event simulator and a tick's arrivals
# as one summed bucket in the cohort engines, so the models part by a few
# ulp of v a round.  The reference's own model tests hold event and cohort
# engines to 1e-5 (models) and 5e-6 (eval losses) on a tiny model, and to
# 5e-5 / 2e-5 on a larger one, and so does this phase.  Its CPU
# rehearsal (reduced mamba2-780m, 2 layers, d_model 256, this
# configuration) read 2.4e-7 (model) and 9.5e-7 (losses)
EVENT_MODEL_ATOL = 5e-5
EVENT_LOSS_ATOL = 2e-5
# columns of one slab where phase 13 holds a kernel's output at model D
# against its plain version slab by slab (the plain version's temporaries
# of a whole [C, D] block would not fit beside the engine's rows)
MODEL_D_SLAB = 1 << 24

# tolerances where a kernel reorders a float sum: the error of a
# reordered f32 sum of n terms is bounded by a small multiple of
# eps * sum|terms|; 1e-5 * sum|terms| leaves ~80x eps(f32) of room
SUM_RTOL = 1e-5
# out rows of cohort_clip_noise with clip > 0: the row norm may differ by
# a few ulp, so each element by a few ulp of |u*s| + |noise term|
ROW_RTOL = 1e-6


# the kernels both cohort engines launch on every tick kind that needs
# them: the server step, the delivery gather, tick_scatter's two passes
TICK_PATH = ("bucket_apply", "tick_deliver", "tick_scatter_rows",
             "tick_scatter_finish")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def median_ms(fn, n: int = 10, reps: int = 7) -> float:
    """Median device time of one call: a CUDA graph of ``n`` calls,
    replayed ``reps`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def kernel_ms(fn, n: int = 20) -> dict:
    """Mean device time of one launch of each kernel that ``fn``
    launches, by kernel name: ``torch.profiler`` over ``n`` calls after a
    warm-up (a breakdown of a wrapper's passes, each launched once a
    call; not counted as launches of the path).  Per launch, not per
    call: a later profiler session in one process may not keep every
    event."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")) or not e.count:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
        out[name.split("(")[0]] = us / 1e3 / e.count
    return out


def scatter_bound(C: int, D: int, G: int, nd: int):
    """tick_scatter's bound: read sent, w, U on the nd done rows, upd, wgt
    and the masks; write w, U and upd; G products and sums per element of
    sent, three operations per element of a done row."""
    return bound(4 * (2 * C * D + nd * D + 2 * G * D + G * C + C
                      + 2 * C * D) + G + C, 2 * G * C * D + 3 * nd * D)


def rows_bound(C: int, D: int, G: int, nd: int, nblk: int):
    """tick_scatter's rows pass alone: read sent, w, U on the nd done
    rows, wgt, eta and done; write w', U' and the nblk block partials; G
    products and sums per element of sent, three operations per element
    of a done row."""
    return bound(4 * (2 * C * D + nd * D + G * C + C + 2 * C * D
                      + nblk * G * D) + C, 2 * G * C * D + 3 * nd * D)


def finish_bound(nblk: int, G: int, D: int):
    """tick_scatter's finish pass alone: read the partials, upd and any_g;
    write the G rows; one add per partial element and one per row."""
    return bound(4 * (nblk * G * D + 2 * G * D) + G, nblk * G * D + G * D)


# rows [lo, hi) of the main shape's client axis: a rank's rows that begin
# and end inside blocks of the whole axis's partition (64 rows a block)
SPLIT_ROWS = (1000, 5000)


def scatter_pass_rows(sargs, fused, plain) -> list:
    """Phase 1 (c): tick_scatter's two entry points at the main shape,
    as the engines launch them.  The rows pass over all C rows under the
    whole axis's partition: w', U' the fused launch's, its partials its
    twin's, bit for bit.  Over ``SPLIT_ROWS`` at their row offset, the
    block begun before lo started from the carry (the rows pass over that
    block's rows before lo): its partials bit for bit the whole's, the
    last (cut) one its twin's.  The finish over the whole's partials, and
    over those with the cut rows' partials in their place, bit for bit the
    fused launch's ring rows.  Each entry point timed beside its twin
    (the plain version) with its bound; returns their kernels-line rows."""
    import torch
    from repro_torch.kernels.tick_fused import (scatter_partition,
                                                tick_scatter_finish,
                                                tick_scatter_finish_twin,
                                                tick_scatter_rows,
                                                tick_scatter_rows_twin)
    sent, w, U, upd, wgt, any_g, done, eta = sargs
    C, D = sent.shape
    G = upd.shape[0]
    rb, nblk = scatter_partition(C)
    rargs = (sent, w, U, wgt, done, eta)
    w1, u1, part = tick_scatter_rows(*rargs, dp_on=True, rows_per_block=rb)
    if not (bits_equal(w1, fused[0]) and bits_equal(u1, fused[1])):
        fail("tick_scatter_rows: w' / U' differ from the fused launch's")
    tw = tick_scatter_rows_twin(*(a.cpu() for a in rargs), dp_on=True,
                                rows_per_block=rb)
    if not bits_equal(part.cpu(), tw[2]):
        fail("tick_scatter_rows: partials are not its twin's bits")
    ring = tick_scatter_finish(part, upd, any_g)
    if not bits_equal(ring, fused[2]):
        fail("tick_scatter_finish over the rows pass's partials is not the "
             "fused tick_scatter's ring rows, bit for bit")
    if not bits_equal(ring.cpu(), tick_scatter_finish_twin(
            part.cpu(), upd.cpu(), any_g.cpu())):
        fail("tick_scatter_finish is not its twin's bits")
    lo, hi = SPLIT_ROWS
    off, b0 = lo % rb, lo // rb

    def rows(a, b):
        return (sent[a:b], w[a:b], U[a:b], wgt[:, a:b], done[a:b], eta[a:b])

    _, _, head = tick_scatter_rows(*rows(lo - off, lo), dp_on=True,
                                   rows_per_block=rb)
    carry = head[0].contiguous()
    _, _, piece = tick_scatter_rows(*rows(lo, hi), dp_on=True,
                                    rows_per_block=rb, row_offset=off,
                                    carry=carry)
    k = (hi - (lo - off)) // rb            # blocks ending before hi
    if not bits_equal(piece[:k], part[b0:b0 + k]):
        fail("tick_scatter_rows at a row offset from a carry: partials "
             "differ from the whole's")
    tp = tick_scatter_rows_twin(*(a.cpu() for a in rows(lo, hi)),
                                dp_on=True, rows_per_block=rb,
                                row_offset=off, carry=carry.cpu())
    if not bits_equal(piece.cpu(), tp[2]):
        fail("tick_scatter_rows at a row offset: not its twin's bits")
    mixed = torch.cat([part[:b0], piece[:k], part[b0 + k:]])
    if not bits_equal(tick_scatter_finish(mixed, upd, any_g), fused[2]):
        fail("tick_scatter_finish over the cut rows' partials is not the "
             "fused tick_scatter's ring rows")
    print(f"phase kernels: (c) tick_scatter_rows over rows [{lo}, {hi}) at "
          f"row offset {off} of {rb}-row blocks from a carry: {k} partials "
          f"bit for bit the whole's, the cut one its twin's; the finish "
          f"bit for bit the fused launch")
    nd = int(done.sum())
    r_ms = median_ms(lambda: tick_scatter_rows(*rargs, dp_on=True,
                                               rows_per_block=rb))
    r_pms = median_ms(lambda: tick_scatter_rows_twin(
        *rargs, dp_on=True, rows_per_block=rb), n=3, reps=3)
    f_ms = median_ms(lambda: tick_scatter_finish(part, upd, any_g))
    f_pms = median_ms(lambda: tick_scatter_finish_twin(part, upd, any_g),
                      n=3, reps=3)
    rbms, rby = rows_bound(C, D, G, nd, nblk)
    fbms, fby = finish_bound(nblk, G, D)
    print(f"phase kernels: tick_scatter_rows C={C} D={D} G={G} blocks="
          f"{nblk} ms={r_ms} bound_ms={rbms} ({rby}) plain_ms={r_pms}; "
          f"tick_scatter_finish ms={f_ms} bound_ms={fbms} ({fby}) "
          f"plain_ms={f_pms}")
    err = float((ring - plain[2]).abs().max())
    src = "src/repro_torch/csrc/tick_fused.cu"
    rep = "src/repro/kernels/tick_fused/kernel.py:129"
    return [dict(name="tick_scatter_rows", route="cuda", source=src,
                 replaces=rep, max_abs_err=0.0, ms=r_ms, plain_ms=r_pms,
                 bound_ms=rbms, bound_by=rby, library_ms=None,
                 plain="tick_scatter_rows_twin"),
            dict(name="tick_scatter_finish", route="cuda", source=src,
                 replaces=rep, max_abs_err=0.0, ms=f_ms, plain_ms=f_pms,
                 bound_ms=fbms, bound_by=fby, library_ms=None,
                 plain="tick_scatter_finish_twin",
                 max_abs_err_vs_torch_sum=err)]


def server_bound(D: int, A: int, *, arr: bool, hit: bool = False,
                 buffered: bool = False, flush: bool = False, fired: int = 0):
    """server_apply's bound for this call's data: read v and, where the
    step needs them, the due slot's A rows, the due overflow row's and the
    buffer; write v', the reset rows (A of the slot, A of the overflow
    entry), the buffer where it changes and the fired broadcast rows; a
    product and a sum per due element, one difference per element of v'."""
    need_due = arr
    rows_in = 1 + (A if need_due else 0) + (A if need_due and hit else 0)
    rows_out = 1 + fired + A + (A if hit else 0)
    if buffered and (arr or flush):
        rows_in += 1
        rows_out += 1
    applied = flush if buffered else arr
    flops = (2 * A * D if need_due else 0) + (D if applied else 0)
    return bound(4.0 * D * (rows_in + rows_out), flops)


def old_server_route(v, ring, slot, dec, has_arr, *, ovf=None,
                     ovf_hit=None, buf=None, flush=None, bc_v=None,
                     fired=None, plain_ring=None, plain_ovf=None):
    """The device engine's server step as separate launches, the way its
    float phase ran before ``server_apply`` took it over: the due
    overflow entry as a masked sum over the bucket, ``ovf_due + slot``,
    FedBuff's bank and flush ``where``s, the flag cast and the kernel of
    ``bucket_apply``, a clone of the whole ring with one slot set to 0.0
    (FedAsync: of both rings), the broadcast rows rewritten whole.  ring
    [L, A, D]; ovf [Q, A, D].  Returns (v', ring, ovf, buf, bc_v), none in
    place: the yardstick of the launches and the time the kernel saves."""
    import torch
    from repro_torch.kernels.tick_fused import bucket_apply
    due = ring[slot]
    if ovf is not None:
        hit_f = ovf_hit.to(torch.float32)
        any_hit = ovf_hit.any()
        if plain_ovf is not None:        # FedAsync's plain bucket too
            torch.where(any_hit, (plain_ovf * hit_f[:, None]).sum(0), 0.0)
            plain_ovf = torch.where(ovf_hit[:, None], 0.0, plain_ovf)
        due = torch.where(any_hit, (ovf * hit_f[:, None, None]).sum(0),
                          0.0) + due
        ovf = torch.where(ovf_hit[:, None, None], 0.0, ovf)
    if buf is not None:
        buf = torch.where(has_arr, buf + due[0], buf)
        flush.reshape(1).to(torch.int32)       # the wrapper's cast launch
        v2 = bucket_apply(v, buf[None, :], dec, flush)
        buf = torch.where(flush, 0.0, buf)
    else:
        has_arr.reshape(1).to(torch.int32)
        v2 = bucket_apply(v, due, dec, has_arr)
    if plain_ring is not None:
        plain_ring = plain_ring.clone()
        plain_ring[slot] = 0.0
    ring = ring.clone()
    ring[slot] = 0.0
    if bc_v is not None:
        bc_v = torch.where(fired[:, None], v2[None, :], bc_v)
    return v2, ring, ovf, buf, bc_v


def server_case(dev, D, kind, far, arr, fl, nf, g, *, L=2, B=4):
    """Operands of one server step at width D (the device engine's
    layout: ring [L, A, D], overflow bucket [Q, A, D], Q = 2, A = B under
    FedAsync), -0.0 planted in v, the due slot, the overflow rows and the
    buffer.  Returns (ring, slot, args, kwargs) for ``server_apply`` on the
    slot's rows; the kwargs' tensors are the ones it writes in place."""
    import torch
    A = B if kind == "fedasync" else 1
    Q = 2

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    v, ring, ovf, buf, bc = rn(D), rn(L, A, D), rn(Q, A, D), rn(D), rn(B, D)
    z = min(D, 12)
    v[:z:2] = -0.0
    ring[1, :, 1:z:3] = -0.0
    ovf[:, :, :z:3] = -0.0
    buf[2:z:2] = -0.0
    hit = torch.zeros(Q, dtype=torch.bool, device=dev)
    hit[1] = far == "due"
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    fired[1:1 + nf] = True
    dec = (0.6 * (torch.arange(A, device=dev, dtype=torch.float32) + 1.0)
           ** -0.5 if A > 1 else torch.ones(1, device=dev))
    kw = dict(reset=True, ovf=ovf if far != "none" else None,
              ovf_hit=hit if far != "none" else None,
              buf=buf if kind == "fedbuff" else None,
              flush=torch.tensor(fl, device=dev),
              bc_v=bc if nf else None, fired=fired)
    return ring, 1, (v, ring[1], dec, torch.tensor(arr, device=dev)), kw


def server_cases():
    """(kind, far tier, has_arr, flush, fired rows): every case of
    ``tests/test_torch_server_apply.py``."""
    for kind in ("paper", "fedasync", "fedbuff"):
        for far in ("none", "due", "idle"):
            for arr in (True, False):
                for fl in ((True, False) if kind == "fedbuff" else (False,)):
                    for nf in (0, 1, 2):
                        yield kind, far, arr, fl, nf


def clone_case(ring, args, kw):
    """A deep copy of ``server_case``'s operands (the slot a view of the
    copied ring again)."""
    ring2 = ring.clone()
    kw2 = {k: (t.clone() if hasattr(t, "clone") else t)
           for k, t in kw.items()}
    return ring2, (args[0].clone(), ring2[1], args[2].clone(),
                   args[3].clone()), kw2


def short_op(name: str) -> str:
    """A device operation's name without its template and arguments."""
    import re
    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "",
                  name)
    return re.split(r"[<(]", name)[0].strip() or name


# torch.profiler sessions that device_ops runs before it gives up, and
# the pad fills that open what a session records (the first events the
# tracer loses, where it loses any: 5 at most seen)
PROFILE_TRIES = 4
PROFILE_PADS = 16


def device_ops(runs, what: str) -> list:
    """Device operations (kernels, copies, fills) of each of ``runs``, by
    short name, one dict a run.  ``runs`` are (setup, run) pairs:
    ``setup()`` makes ``run``'s argument outside the profiler.  One
    ``torch.profiler`` session holds every run, each between device syncs
    and between probe kernels (``torch.cuda._sleep(0)``, not counted), so
    the device events between two probes are that run's own (no mapping
    of the device timeline onto the host's clock).  A session on the card
    has been seen to lose its first device events every time after the
    process's first session, and once to record no device event at all:
    so the session records only after a warm-up step (the profiler's
    schedule: the tracer starts during it and its events are dropped), a
    pause and PROFILE_PADS fills of a pad tensor open what it records and
    one fill closes it, outside the probes and not counted, and a session
    that lacks a probe is
    discarded and run again from fresh setups, at most PROFILE_TRIES
    sessions in all.  Returns (counts, sessions discarded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    pad = torch.empty(1, device="cuda")
    for attempt in range(PROFILE_TRIES):
        args = [setup() for setup, _ in runs]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(4):
                pad.fill_(0.0)
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            prof.step()                 # warm-up over: record from here
            time.sleep(0.05)
            for _ in range(PROFILE_PADS):
                pad.fill_(0.0)
            torch.cuda.synchronize()
            for (_, run), a in zip(runs, args):
                torch.cuda._sleep(0)
                torch.cuda.synchronize()
                run(a)
                torch.cuda.synchronize()
            torch.cuda._sleep(0)
            torch.cuda.synchronize()
            pad.fill_(0.0)
            torch.cuda.synchronize()
            prof.step()                 # the recording ends
        evs = sorted((e for e in prof.events()
                      if "CUDA" in str(getattr(e, "device_type", ""))),
                     key=lambda e: e.time_range.start)
        probes = [i for i, e in enumerate(evs) if "spin_kernel" in e.name]
        if len(probes) == len(runs) + 1:
            out = []
            for i0, i1 in zip(probes, probes[1:]):
                cnt = {}
                for e in evs[i0 + 1:i1]:
                    key = short_op(e.name)
                    cnt[key] = cnt.get(key, 0) + 1
                out.append(cnt)
            return out, attempt
        lead = probes[0] if probes else len(evs)
        tail = len(evs) - 1 - probes[-1] if probes else 0
        print(f"{what}: profiler session {attempt + 1} recorded "
              f"{len(probes)} of {len(runs) + 1} probes and {len(evs)} "
              f"device events ({lead} before the first probe, {tail} after "
              f"the last, {PROFILE_PADS} and 1 sent): discarded")
    fail(f"{what}: {PROFILE_TRIES} profiler sessions in turn lost device "
         f"events")


def clip_bound(N: int, D: int, esz: int):
    """clip_accumulate's bound: read G once, write D f32; a product and a
    sum per element for the norms and again for the scaled sums."""
    return bound(esz * N * D + 4.0 * D, 4.0 * N * D)


def scatter_planted_drop(args, plain) -> float:
    """A planted fault read against tick_scatter's plain ring rows: the
    ring rows with the middle block's partial left out of the finish pass
    (the kernel's add order, ``tick_scatter_twin``'s, on the CPU).
    Returns max |faulty - plain| / (SUM_RTOL * sum|terms|): above 1, the
    limit catches it."""
    import torch
    from repro_torch.kernels import row_tiles
    from repro_torch.kernels.tick_fused.ref import SCATTER_TILE_ROWS
    sent, _, _, upd, wgt, any_g, _, _ = (a.cpu() for a in args)
    rb, _ = row_tiles.partition(sent.shape[0], SCATTER_TILE_ROWS)
    part = row_tiles.block_sums(wgt.T[:, :, None] * sent[:, None, :], rb)
    part[part.shape[0] // 2] = 0.0
    faulty = torch.where(any_g[:, None], upd + row_tiles.finish_tree(part),
                         upd)
    tol = SUM_RTOL * (wgt.abs() @ sent.abs()) + 1e-30
    return float(((faulty - plain.cpu()).abs() / tol).max())


def clip_planted_drop(G, clip: float, plain) -> float:
    """The same planted fault for clip_accumulate (``clip_accumulate_twin``'s
    order): max |faulty - plain| / (SUM_RTOL * sum|terms|)."""
    from repro_torch.kernels import row_tiles
    from repro_torch.kernels.dp_clip.ref import (TILE_ROWS,
                                                 clip_accumulate_ref,
                                                 row_scales)
    g = G.cpu()
    rb, _ = row_tiles.partition(g.shape[0], TILE_ROWS[g.dtype])
    part = row_tiles.block_sums(g.float() * row_scales(g, clip)[:, None], rb)
    part[part.shape[0] // 2] = 0.0
    tol = SUM_RTOL * clip_accumulate_ref(g.abs(), clip) + 1e-30
    return float(((row_tiles.finish_tree(part) - plain.cpu()).abs()
                  / tol).max())


def print_ptxas(what: str, log: str, kernels) -> None:
    """Print the ptxas lines of ``kernels`` in ``log``; fail on a spill."""
    rep = [r for kern in kernels for r in ptxas_report(log, kern)]
    for take, line in rep or [(what, "(library cached: no ptxas report)")]:
        print(f"phase kernels: {what} ptxas: {take}: {line}")
    if spill_bytes(rep):
        fail(f"{what}: a kernel spills registers")


def bound_terms(nbytes: float, flops: float, int_ops: float = 0.0):
    """(bytes ms, operations ms): the bytes over the memory rate, the
    operations over the peak rate of their type (f32 and int32 run on
    separate units, so the operations take the longer of the two)."""
    t_o = max(flops / F32_FLOPS, int_ops / INT32_OPS)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * t_o


def bound(nbytes: float, flops: float, int_ops: float = 0.0):
    t_b, t_o = bound_terms(nbytes, flops, int_ops)
    return (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def server_step_kernel(dev, D: int, B: int, L: int, g) -> dict:
    """Row 1's kernel as the server step (``server_apply``): bit for bit
    its twin on the card, on v' and every row it writes in place, in every
    case of the CPU test at D (A = 1, and A = B = R under FedAsync), two
    launches alike; then the 10-call graph time of the ticks of the main
    run and of scenarios (a) and (b), beside the twin's and the
    separate-launch route's (``old_server_route``) on the same operands,
    and each call's bound.  Returns row 1's keys."""
    import torch
    from repro_torch.kernels.tick_fused import server_apply, server_apply_ref
    n = 0
    for case in server_cases():
        ring0, _, args0, kw0 = server_case(dev, D, *case, g, L=L, B=B)
        outs = []
        for fn in (server_apply, server_apply, server_apply_ref):
            ring, args, kw = clone_case(ring0, args0, kw0)
            outs.append((fn(*args, **kw), ring, kw["ovf"], kw["buf"],
                         kw["bc_v"]))
        for a, b, c in zip(*outs):
            if a is None:
                continue
            if not (bits_equal(a, b) and bits_equal(a, c)):
                fail(f"server_apply {case} at D={D}: not bitwise equal to "
                     f"its twin / itself")
        n += 1
    print(f"phase kernels: server_apply bitwise against server_apply_ref "
          f"in {n} cases at D={D} (A = 1 and A = {B}), -0.0 planted")
    # the ticks: main (paper, no far tier), (a) FedAsync (A = R, no far
    # tier), (b) FedBuff with an overflow entry due; each without and with
    # one fired broadcast row
    ticks = dict(main=("paper", "none", False), a=("fedasync", "none", False),
                 b=("fedbuff", "due", True))
    res = {}
    for tag, (kind, far, fl) in ticks.items():
        for nf in (0, 1):
            ring, slot, args, kw = server_case(dev, D, kind, far, True, fl,
                                               nf, g, L=L, B=B)
            A = args[1].shape[0]
            okw = {k: kw[k] for k in ("ovf", "ovf_hit", "buf", "flush",
                                      "bc_v", "fired")}
            if kind == "fedasync":
                okw.update(plain_ring=torch.zeros((L, D), device=dev))
            t_k = median_ms(lambda: server_apply(*args, **kw))
            t_p = median_ms(lambda: server_apply_ref(*args, **kw))
            t_o = median_ms(lambda: old_server_route(
                args[0], ring, slot, args[2], args[3], **okw))
            bms, by = server_bound(D, A, arr=True, hit=far == "due",
                                   buffered=kind == "fedbuff", flush=fl,
                                   fired=nf)
            key = f"{tag}{'_cascade' if nf else ''}"
            res[key] = dict(ms=t_k, plain_ms=t_p, old_route_ms=t_o,
                            bound_ms=bms, bound_by=by)
            print(f"phase kernels: server_apply tick {key} ({kind}, far "
                  f"{far}, flush {fl}, fired {nf}) D={D} A={A}: ms={t_k} "
                  f"plain_ms={t_p} old_route_ms={t_o} bound_ms={bms} ({by})")
    m = res["main"]
    return dict(ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
                bound_by=m["bound_by"], old_route_ms=m["old_route_ms"],
                server_ticks=res)


def phase_kernels(dev, logs):
    """Phase 1: each kernel against its plain version at the main run's
    shapes; returns the kernels' JSON entries (launches filled later).
    ``logs``: the nvcc logs of the sources built by this run."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                               cohort_clip_noise_prng,
                                               cohort_clip_noise_prng_ref,
                                               counter_normals)
    from repro_torch.kernels.cohort_dp.kernel import prng_words_probe
    from repro_torch.kernels.cohort_dp.ref import cohort_clip_noise_ref
    from repro_torch.kernels.tick_fused import (bucket_apply,
                                                bucket_apply_ref,
                                                tick_deliver,
                                                tick_deliver_ref,
                                                tick_scatter,
                                                tick_scatter_ref,
                                                tick_scatter_twin)

    from repro_torch.cohort.state import next_pow2

    C, D = MAIN["C"], MAIN["d"] + 1
    B = next_pow2(MAIN["d_gate"] + 2)
    L = 2                              # uniform plan at dt = block: ring of 2
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    def rand(*s):
        return torch.rand(s, generator=g, device=dev)

    out = []
    f4 = 4

    # -- bucket_apply: A = 1, a -0.0 row against a -0.0 server vector ----
    v = randn(D)
    rows = randn(1, D)
    v[:16] = -0.0
    rows[0, :16] = -0.0
    dec = torch.ones(1, device=dev)
    err = 0.0
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        k1 = bucket_apply(v, rows, dec, fl)
        k2 = bucket_apply(v, rows, dec, fl)
        p = bucket_apply_ref(v, rows, dec, fl)
        if not (bits_equal(k1, p) and bits_equal(k1, k2)):
            fail(f"bucket_apply (flag={flag}) is not bitwise equal to its "
                 f"plain version / itself")
        err = max(err, float((k1 - p).abs().max()))
    fl = torch.tensor(True, device=dev)
    ms = median_ms(lambda: bucket_apply(v, rows, dec, fl))
    pms = median_ms(lambda: bucket_apply_ref(v, rows, dec, fl))
    # one PyTorch call computing v - rows^T dec (the flag on)
    lms = median_ms(lambda: torch.addmv(v, rows.T, dec, alpha=-1))
    bms, by = bound(f4 * (3 * D + 1) + 4, 2 * D)
    # the launch floor: an empty kernel (a zero-cycle spin) in the same
    # graph of 10 calls, so a row near it reads as launch-bound
    floor_ms = median_ms(lambda: torch.cuda._sleep(0))
    print(f"phase kernels: launch floor (empty kernel, 10-call graph) "
          f"ms={floor_ms}; bucket_apply ms={ms}")
    row1 = dict(name="bucket_apply", route="cuda",
                source="src/repro_torch/csrc/tick_fused.cu",
                replaces="src/repro/kernels/tick_fused/kernel.py:78",
                max_abs_err=err, ms_bucket_apply=ms,
                plain_ms_bucket_apply=pms, bound_ms_bucket_apply=bms,
                library_ms=lms, launch_floor_ms=floor_ms)
    row1.update(server_step_kernel(dev, D, B, L, g))
    out.append(row1)

    # -- tick_deliver ------------------------------------------------------
    w, U, bc_v = randn(C, D), randn(C, D), randn(B, D)
    best = torch.randint(0, B, (C,), generator=g, device=dev)
    take = rand(C) < 0.7
    eta = 0.1 * rand(C)
    k1 = tick_deliver(w, U, bc_v, best, take, eta)
    k2 = tick_deliver(w, U, bc_v, best, take, eta)
    p = tick_deliver_ref(w, U, bc_v, best, take, eta)
    if not (bits_equal(k1, p) and bits_equal(k1, k2)):
        fail("tick_deliver is not bitwise equal to its plain version / "
             "itself")
    ms = median_ms(lambda: tick_deliver(w, U, bc_v, best, take, eta))
    pms = median_ms(lambda: tick_deliver_ref(w, U, bc_v, best, take, eta))
    nt = int(take.sum())
    # taken rows read U, the others w; every row is written
    bms, by = bound(f4 * (2 * C * D + B * D + C) + 8 * C + C, 2 * nt * D)
    out.append(dict(name="tick_deliver", route="cuda",
                    source="src/repro_torch/csrc/tick_fused.cu",
                    replaces="src/repro/kernels/tick_fused/kernel.py:102",
                    max_abs_err=float((k1 - p).abs().max()), ms=ms,
                    plain_ms=pms, bound_ms=bms, bound_by=by,
                    library_ms=None))

    # -- tick_scatter: ring row 1 receives nobody (guarded add) -----------
    sent, upd = randn(C, D), randn(L, D)
    done = rand(C) < 0.5
    in_ls = [done, torch.zeros_like(done)]
    wgt = torch.stack([eta * m.to(torch.float32) for m in in_ls])
    any_g = torch.stack([m.any() for m in in_ls])
    kw1 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    kw2 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    pw = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    for a, b, what in ((kw1[0], pw[0], "w"), (kw1[1], pw[1], "U")):
        if not bits_equal(a, b):
            fail(f"tick_scatter {what} output is not bitwise equal to its "
                 f"plain version")
    if not all(bits_equal(a, b) for a, b in zip(kw1, kw2)):
        fail("tick_scatter: two launches differ")
    if not bits_equal(kw1[2][1], upd[1]):
        fail("tick_scatter: the empty ring row changed (guarded add)")
    absum = wgt.abs() @ sent.abs()                     # [G, D] sum|terms|
    diff = (kw1[2] - pw[2]).abs()
    if not bool((diff <= SUM_RTOL * absum + 1e-30).all()):
        fail(f"tick_scatter ring rows off by {float(diff.max())} "
             f"(> {SUM_RTOL} * sum|terms|)")
    sargs = (sent, w, U, upd, wgt, any_g, done, eta)
    twin = tick_scatter_twin(*(a.cpu() for a in sargs), dp_on=True)
    if not all(bits_equal(a.cpu(), b) for a, b in zip(kw1, twin)):
        fail("tick_scatter is not bitwise equal to its order-exact twin")
    planted = scatter_planted_drop(sargs, pw[2])
    print(f"phase kernels: tick_scatter planted fault (a block partial "
          f"left out of the finish pass): max diff / limit = {planted}")
    if not planted > 1.0:
        fail("tick_scatter: SUM_RTOL passes a dropped block partial")
    print_ptxas("tick_scatter", logs.get("tick_fused", ""),
                ("tick_scatter_rows_kernel", "finish_kernel"))
    err = max(float((a - b).abs().max()) for a, b in zip(kw1, pw))
    ms = median_ms(lambda: tick_scatter(*sargs, dp_on=True))
    pms = median_ms(lambda: tick_scatter_ref(*sargs, dp_on=True))
    passes = kernel_ms(lambda: tick_scatter(*sargs, dp_on=True))
    nd = int(done.sum())
    bms, by = scatter_bound(C, D, L, nd)
    print(f"phase kernels: tick_scatter C={C} D={D} G={L} done={nd} ms={ms} "
          f"passes_ms={passes} bound_ms={bms} ({by}) plain_ms={pms}")
    scatter = dict(name="tick_scatter", route="cuda",
                   source="src/repro_torch/csrc/tick_fused.cu",
                   replaces="src/repro/kernels/tick_fused/kernel.py:129",
                   max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                   bound_by=by, library_ms=None, on_path=False,
                   path_route="tick_scatter_rows + tick_scatter_finish")
    out.append(scatter)
    out += scatter_pass_rows(sargs, kw1, pw)

    # -- cohort_clip_noise: clip > 0 and clip = 0 -------------------------
    u = 0.05 * randn(C, D) * (2.0 * rand(C))[:, None]   # norms in [0, 2.8]
    noise = randn(C, D)
    mask = done
    wts = eta * mask.to(torch.float32)
    ns = 0.1 * 8.0
    err = 0.0
    for clip in (1.0, 0.0):
        o1, a1 = cohort_clip_noise(u, noise, wts, mask, clip=clip,
                                   noise_scale=ns)
        o2, a2 = cohort_clip_noise(u, noise, wts, mask, clip=clip,
                                   noise_scale=ns)
        po, pa = cohort_clip_noise_ref(u, noise, wts, mask, clip=clip,
                                       noise_scale=ns)
        if not (bits_equal(o1, o2) and bits_equal(a1, a2)):
            fail(f"cohort_clip_noise (clip={clip}): two launches differ")
        if clip == 0.0 and not bits_equal(o1, po):
            fail("cohort_clip_noise (clip=0) rows are not bitwise equal "
                 "to the plain version")
        row_tol = ROW_RTOL * (u.abs() + ns * noise.abs())
        if not bool(((o1 - po).abs() <= row_tol).all()):
            fail(f"cohort_clip_noise (clip={clip}) rows off by "
                 f"{float((o1 - po).abs().max())}")
        agg_tol = SUM_RTOL * (wts.abs() @ po.abs())
        if not bool(((a1 - pa).abs() <= agg_tol + 1e-30).all()):
            fail(f"cohort_clip_noise (clip={clip}) agg off by "
                 f"{float((a1 - pa).abs().max())}")
        err = max(err, float((o1 - po).abs().max()),
                  float((a1 - pa).abs().max()))
        o3, a3 = cohort_clip_noise(u, noise, wts, mask, clip=clip,
                                   noise_scale=ns, with_agg=False)
        if a3 is not None or not bits_equal(o3, o1):
            fail(f"cohort_clip_noise (clip={clip}, with_agg=False): agg "
                 f"not None or rows differ from with_agg=True")
    # timed as the main run calls it: no round clip, noise on; with agg
    # (as in earlier runs) and without (as the engine calls it)
    ms = median_ms(lambda: cohort_clip_noise(u, noise, wts, mask, clip=0.0,
                                             noise_scale=ns))
    ms_noagg = median_ms(lambda: cohort_clip_noise(
        u, noise, wts, mask, clip=0.0, noise_scale=ns, with_agg=False))
    pms = median_ms(lambda: cohort_clip_noise_ref(u, noise, wts, mask,
                                                  clip=0.0, noise_scale=ns))
    # read u and the noise of masked rows, mask, weights; write out, agg
    bms, by = bound(f4 * (C * D + nd * D + 2 * C + C * D + D),
                    4 * C * D + 2 * C * D)
    print(f"phase kernels: cohort_clip_noise C={C} D={D} masked_share="
          f"{nd / C} ms_with_agg={ms} ms_without_agg={ms_noagg} "
          f"bound_ms={bms} ({by})")
    out.append(dict(name="cohort_clip_noise", route="cuda",
                    source="src/repro_torch/csrc/cohort_dp.cu",
                    replaces="src/repro/kernels/cohort_dp/kernel.py:103",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None))

    # -- cohort_clip_noise_prng: the stream; then at no, half and all rows
    # masked, clip > 0 and clip = 0, with and without agg, on a copy of u
    # with signed zeros in two of every five columns --------------------
    key = prng.fold_in(prng.PRNGKey(MAIN["seed"] ^ NOISE_SALT), 1)
    w0, w1 = prng_words_probe(key, C * D, dev)
    p0, p1 = prng.counter_words(key, C * D, device=dev)
    if not (torch.equal(w0, p0) and torch.equal(w1, p1)):
        fail("cohort_clip_noise_prng: the kernel's threefry stream differs "
             "from repro_torch.prng on the flat index")
    del w0, w1, p0, p1
    n = counter_normals(key, C, D, device=dev)
    u_z = u.clone()
    u_z[:, ::5] = -0.0
    u_z[:, 1::5] = 0.0
    neg0 = u_z.view(torch.int32) == -2 ** 31
    # no row masked is close to the scenario runs' case: a launch there
    # masks few rows (this script's scenarios phase prints the share)
    masks = {0.0: torch.zeros_like(mask), 0.5: mask,
             1.0: torch.ones_like(mask)}
    err = 0.0
    for share, m in masks.items():
        w_m = eta * m.to(torch.float32)
        for clip in (1.0, 0.0):
            what = f"cohort_clip_noise_prng (share={share}, clip={clip})"
            o1, a1 = cohort_clip_noise_prng(u_z, key, w_m, m, clip=clip,
                                            noise_scale=ns)
            o2, a2 = cohort_clip_noise_prng(u_z, key, w_m, m, clip=clip,
                                            noise_scale=ns)
            o3, a3 = cohort_clip_noise_prng(u_z, key, w_m, m, clip=clip,
                                            noise_scale=ns, with_agg=False)
            po, pa = cohort_clip_noise_prng_ref(u_z, key, w_m, m, clip=clip,
                                                noise_scale=ns)
            if not (bits_equal(o1, o2) and bits_equal(a1, a2)):
                fail(f"{what}: two launches differ")
            if a3 is not None or not bits_equal(o3, o1):
                fail(f"{what}: with_agg=False gave an agg or other rows")
            # pass-through rows: u itself, but -0.0 takes the sign of 0 * n
            pt = ~m
            if not bits_equal(o1[pt], po[pt]):
                fail(f"{what}: pass-through rows are not the plain "
                     f"version's bits")
            keep = pt[:, None] & ~neg0
            if not bits_equal(o1[keep], u_z[keep]):
                fail(f"{what}: pass-through rows are not u")
            # CUDA's logf / cosf against PyTorch's log / cos: a few ulp of n
            row_tol = ROW_RTOL * (u_z.abs() + ns * n.abs())
            if not bool(((o1 - po).abs() <= row_tol).all()):
                fail(f"{what} rows off by {float((o1 - po).abs().max())}")
            agg_tol = SUM_RTOL * (w_m.abs() @ po.abs())
            if not bool(((a1 - pa).abs() <= agg_tol + 1e-30).all()):
                fail(f"{what} agg off by {float((a1 - pa).abs().max())}")
            err = max(err, float((o1 - po).abs().max()),
                      float((a1 - pa).abs().max()))
            z = pt[:, None] & neg0
            print(f"phase kernels: {what} ok: max_abs_err="
                  f"{float((o1 - po).abs().max())} pass-through -0.0 "
                  f"elements {int(z.sum())}, "
                  f"{int((o1.view(torch.int32)[z] == 0).sum())} now +0.0")
    del n, o1, o2, o3, po, u_z, neg0
    # timed at the main run's shapes on u (no planted zeros): no, half and
    # all rows masked, with agg and without (the engine's call).  Bound: read
    # u, mask (and weights); write out (and agg); a hash and its normal
    # for each element of a masked row only
    times = {}
    for share, m in masks.items():
        w_m = eta * m.to(torch.float32)
        hashed = int(m.sum()) * D
        for with_agg in (True, False):
            t = median_ms(lambda: cohort_clip_noise_prng(
                u, key, w_m, m, clip=0.0, noise_scale=ns,
                with_agg=with_agg))
            nbytes = f4 * (2 * C * D + C + (C + D if with_agg else 0))
            b_ms, o_ms = bound_terms(nbytes, PRNG_F32_OPS * hashed,
                                     PRNG_INT_OPS * hashed)
            bms, by = bound(nbytes, PRNG_F32_OPS * hashed,
                            PRNG_INT_OPS * hashed)
            times[(share, with_agg)] = (t, bms, by)
            print(f"phase kernels: cohort_clip_noise_prng C={C} D={D} "
                  f"masked_share={share} with_agg={with_agg} "
                  f"bound_ms={bms} ({by}) bound_bytes_ms={b_ms} "
                  f"bound_ops_ms={o_ms} (int32 {PRNG_INT_OPS}/hashed elt, "
                  f"f32 {PRNG_F32_OPS}/hashed elt, {hashed} hashed) ms={t}")
    ms, bms, by = times[(0.5, True)]
    pms = median_ms(lambda: cohort_clip_noise_prng_ref(
        u, key, wts, mask, clip=0.0, noise_scale=ns), n=3, reps=3)
    # (c) a rank's rows [lo, hi) with row_offset: the whole draw's rows
    lo, hi = SPLIT_ROWS
    whole, _ = cohort_clip_noise_prng(u, key, wts, mask, clip=1.0,
                                      noise_scale=ns, with_agg=False)
    rows, _ = cohort_clip_noise_prng(u[lo:hi], key, wts[lo:hi],
                                     mask[lo:hi], clip=1.0, noise_scale=ns,
                                     with_agg=False, row_offset=lo)
    if not bits_equal(rows, whole[lo:hi]):
        fail("cohort_clip_noise_prng at a row offset is not the whole "
             "draw's rows, bit for bit")
    off_ms = median_ms(lambda: cohort_clip_noise_prng(
        u[lo:hi], key, wts[lo:hi], mask[lo:hi], clip=0.0, noise_scale=ns,
        with_agg=False, row_offset=lo))
    print(f"phase kernels: (c) cohort_clip_noise_prng rows [{lo}, {hi}) at "
          f"row_offset={lo}: bit for bit the whole draw's rows; "
          f"ms={off_ms} (whole, without agg: {times[(0.5, False)][0]})")
    out.append(dict(name="cohort_clip_noise_prng", route="cuda",
                    source="src/repro_torch/csrc/cohort_dp.cu",
                    replaces="src/repro/kernels/cohort_dp/kernel.py:139",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None,
                    ms_row_offset_rows=[lo, hi], ms_row_offset=off_ms))

    # -- FedAsync's shapes: bucket_apply at A = R, tick_scatter at G = L*R
    R = B
    rows_r = randn(R, D)
    rows_r[2] = 0.0                              # an empty stratum
    dec_r = 0.6 * (torch.arange(R, device=dev, dtype=torch.float32)
                   + 1.0) ** -0.5
    for flag in (True, False):
        fl = torch.tensor(flag, device=dev)
        k1 = bucket_apply(v, rows_r, dec_r, fl)
        if not bits_equal(k1, bucket_apply(v, rows_r, dec_r, fl)):
            fail("bucket_apply (A = R): two launches differ")
        p = bucket_apply_ref(v, rows_r, dec_r, fl)
        tol = SUM_RTOL * (dec_r.abs() @ rows_r.abs())
        if not bool(((k1 - p).abs() <= tol + 1e-30).all()):
            fail(f"bucket_apply (A = R, flag={flag}) off by "
                 f"{float((k1 - p).abs().max())}")
        if not flag and not bits_equal(k1, v):
            fail("bucket_apply (A = R): flag off changed v")
    G = L * R
    slot = torch.randint(0, L, (C,), generator=g, device=dev)
    kmod = torch.randint(0, R, (C,), generator=g, device=dev)
    masks = torch.stack([done & (slot == sl) & (kmod == r)
                         for sl in range(L) for r in range(R)])
    masks[G - 1] = False                         # a row nobody reaches
    wgt = eta[None, :] * masks.float()
    any_g = masks.any(1)
    upd = randn(G, D)
    kw1 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    kw2 = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    pw = tick_scatter_ref(sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)
    if not (bits_equal(kw1[0], pw[0]) and bits_equal(kw1[1], pw[1])):
        fail("tick_scatter (G = L * R): w / U not bitwise")
    if not all(bits_equal(a, b) for a, b in zip(kw1, kw2)):
        fail("tick_scatter (G = L * R): two launches differ")
    if not bits_equal(kw1[2][G - 1], upd[G - 1]):
        fail("tick_scatter (G = L * R): the empty row changed")
    diff = (kw1[2] - pw[2]).abs()
    if not bool((diff <= SUM_RTOL * (wgt.abs() @ sent.abs()) + 1e-30).all()):
        fail(f"tick_scatter (G = L * R) rows off by {float(diff.max())}")
    sargs = (sent, w, U, upd, wgt, any_g, done, eta)
    twin = tick_scatter_twin(*(a.cpu() for a in sargs), dp_on=True)
    if not all(bits_equal(a.cpu(), b) for a, b in zip(kw1, twin)):
        fail("tick_scatter (G = L * R) is not bitwise equal to its twin")
    gms = median_ms(lambda: tick_scatter(*sargs, dp_on=True))
    passes = kernel_ms(lambda: tick_scatter(*sargs, dp_on=True))
    gbms, _ = scatter_bound(C, D, G, nd)
    scatter.update(ms_g8=gms, bound_g8_ms=gbms)
    print(f"phase kernels: FedAsync shapes ok: bucket_apply A={R} "
          f"dec={dec_r.tolist()}; tick_scatter G={G} ms={gms} "
          f"passes_ms={passes} bound_ms={gbms} "
          f"max_abs_err={float(diff.max())}")
    return out


def make_sim(dev, X, y, *, C, sizes, etas, d, seed, block, l2,
             dp_clip=0.0, dp_sigma=0.0, dp_round_clip=0.0, sample_seed=0,
             scenario=None, strategy=None, dp_rng="operand", host=False,
             trace=None, mesh=None):
    """The device engine (over ``mesh``, a ``clients`` mesh, where given),
    or with ``host`` the host-loop engine (operand noise only); ``trace``
    is the engines' JSONL ``trace=``."""
    import repro_torch as rt
    task = rt.LogRegTask(X, y, l2=l2, dp_clip=dp_clip, dp_sigma=dp_sigma,
                         sample_seed=sample_seed)
    kw = dict(n_clients=C, sizes_per_client=sizes, round_stepsizes=etas,
              d=d, seed=seed, block=block, dp_round_clip=dp_round_clip,
              scenario=scenario, strategy=strategy, device=dev, trace=trace)
    if host:
        return rt.CohortSimulator(task, **kw)
    return rt.DeviceCohortSimulator(task, dp_rng=dp_rng, mesh=mesh, **kw)


def timed_run(sim, rounds, eval_every):
    import torch
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(max_rounds=rounds, eval_every=eval_every)
    return res, time.perf_counter() - t0


def run_sim(dev, X, y, *, rounds, eval_every, **kw):
    sim = make_sim(dev, X, y, **kw)
    res, wall = timed_run(sim, rounds, eval_every)
    return sim, res, wall


def time_noise(eng):
    """Record CUDA events around each round-completion noise call of the
    engine (no host sync); returns a function giving the summed ms."""
    import torch
    spans = []
    inner = eng._clip_noise

    def timed(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = inner(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out

    eng._clip_noise = timed
    return lambda: sum(a.elapsed_time(b) for a, b in spans)


def count_masked(eng):
    """Record the masked rows of each round-completion noise call as a
    device count (no host sync); returns a function giving them as ints."""
    import torch
    counts = []
    inner = eng._clip_noise

    def counted(U, eta, done, t):
        counts.append(done.sum())
        return inner(U, eta, done, t)

    eng._clip_noise = counted
    return lambda: torch.stack(counts).tolist() if counts else []


class count_normal_draws:
    """Count ``repro_torch.prng.normal`` / ``normal_rows`` calls (the
    operand noise draw) while the context is open."""

    NAMES = ("normal", "normal_rows")

    def __enter__(self):
        from repro_torch import prng
        self.n = 0
        self._inner = {name: getattr(prng, name) for name in self.NAMES}

        def counting(fn):
            def counted(*a, **k):
                self.n += 1
                return fn(*a, **k)
            return counted

        for name, fn in self._inner.items():
            setattr(prng, name, counting(fn))
        return self

    def __exit__(self, *exc):
        from repro_torch import prng
        for name, fn in self._inner.items():
            setattr(prng, name, fn)


def int_state(eng):
    """The integer protocol state: every int32 state field, the
    iteration census, on the CPU."""
    import torch
    st = eng.local_state
    return {f: getattr(st, f).cpu() for f in st._fields
            if getattr(st, f).dtype == torch.int32}


def phase_census(dev):
    """Phase 2: FedSGD census at C = 4096, and a small DP run against the
    port's own plain CPU run."""
    import numpy as np
    import torch
    import repro_torch as rt

    X, y = rt.make_binary_dataset(2048, 32, seed=0, noise=0.3)
    sim, res, wall = run_sim(dev, X, y, C=FEDSGD_C, sizes=[1] * 8,
                             etas=[0.1] * 8, d=1, seed=0, block=64,
                             rounds=8, eval_every=8, l2=1.0 / 2048)
    ops = res["telemetry"].ops
    for k, want in FEDSGD_OPS.items():
        if ops[k] != want:
            fail(f"FedSGD census {k}={ops[k]}, want {want}")
    if sim.engine.fused_iters != FEDSGD_ITERS:
        fail(f"FedSGD fused_iters={sim.engine.fused_iters}, want "
             f"{FEDSGD_ITERS}")
    print(f"phase fedsgd_census: C={FEDSGD_C} ops={ops} "
          f"fused_iters={sim.engine.fused_iters} wall_s={wall} "
          f"client_rounds_per_s={FEDSGD_C * 8 / wall}")

    # small DP case: the card against the plain versions on the CPU
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    kw = dict(C=6, sizes=[4, 6, 8], etas=[0.1, 0.08, 0.06], d=2, seed=2,
              block=4, rounds=3, eval_every=1, l2=1.0 / 300, dp_clip=0.1,
              dp_sigma=8.0, dp_round_clip=1.0, sample_seed=21)
    _, gpu, wall = run_sim(dev, X, y, **kw)
    _, cpu, _ = run_sim(torch.device("cpu"), X, y, **kw)
    for k in ("round", "messages", "broadcasts"):
        if gpu["final"][k] != cpu["final"][k]:
            fail(f"small DP run: {k} {gpu['final'][k]} != {cpu['final'][k]}")
    if gpu["telemetry"].ops != cpu["telemetry"].ops:
        fail("small DP run: op census differs between card and CPU")
    lg = np.array([h["loss"] for h in gpu["history"]])
    lc = np.array([h["loss"] for h in cpu["history"]])
    if not np.allclose(lg, lc, rtol=1e-5, atol=1e-7):
        fail(f"small DP run: losses {lg} vs CPU {lc}")
    print(f"phase small_dp_agreement: losses card={lg.tolist()} "
          f"cpu={lc.tolist()} max_rel={float(np.max(np.abs(lg - lc) / lc))}"
          f" wall_s={wall}")


def main_inputs():
    import repro_torch as rt
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.core.sequences import sample_sizes
    from repro_torch.core.stepsizes import round_stepsizes
    cfg = fl_config_fig1b()
    m = MAIN
    X, y = rt.make_binary_dataset(m["n"], m["d"], seed=m["seed"], noise=0.3)
    sizes = sample_sizes(cfg.sample_seq, m["rounds"] + m["d_gate"] + 1)
    etas = round_stepsizes(cfg.step_size, sizes)
    kw = dict(C=m["C"], sizes=sizes, etas=etas, d=m["d_gate"],
              seed=m["seed"], l2=1.0 / m["n"], dp_clip=cfg.dp.clip_norm,
              dp_sigma=cfg.dp.sigma)
    return X, y, kw


def record_blocks(eng) -> list:
    """Keep a copy of the per-client arguments (i, h, n, eta) and the
    block of each of the engine's client-block calls (no host sync)."""
    calls = []
    inner = eng.ltask.run_block

    def recorded(w, U, i, h, n, eta, block, **k):
        calls.append((i.clone(), h.clone(), n.clone(), eta.clone(), block))
        return inner(w, U, i, h, n, eta, block, **k)

    eng.ltask.run_block = recorded
    return calls


def phase_main(dev, X, y, kw):
    """Phase 3: the main run, with the kernels' launch counts; then the
    same configuration with the noise generated in the kernel.  Returns
    the operand run's launches, both runs' fingerprints and the operand
    run's client-block calls (``record_blocks``) with its task and last
    rows."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.telemetry import check_ops

    m = MAIN
    out, fps = {}, {}
    for dp_rng in ("operand", "in_kernel"):
        sim = make_sim(dev, X, y, block=m["block"], dp_rng=dp_rng, **kw)
        eng = sim.engine
        noise_ms = time_noise(eng)
        calls = record_blocks(eng)
        torch.cuda.reset_peak_memory_stats(dev)
        launches.reset()
        with count_normal_draws() as draws:
            res, wall = timed_run(sim, m["rounds"], m["rounds"] // 2)
        counts = dict(launches.LAUNCHES)
        tel = res["telemetry"]
        if res["final"]["round"] < m["rounds"]:
            fail(f"main run ({dp_rng}) reached round "
                 f"{res['final']['round']}")
        probs = check_ops(tel.ops, messages=tel.messages,
                          broadcasts=tel.broadcasts,
                          far_messages=tel.far_messages, clients=m["C"],
                          ticks=tel.ticks, loop_iters=eng.fused_iters[0],
                          block_iters=eng.fused_iters[1])
        if probs:
            fail(f"main run ({dp_rng}) op census: {probs}")
        losses = [h["loss"] for h in res["history"]] + [res["final"]["loss"]]
        if not all(math.isfinite(x) for x in losses):
            fail(f"main run ({dp_rng}) losses not finite: {losses}")
        v = res["model"]["w"]
        if tuple(v.shape) != (m["d"],) or not bool(torch.isfinite(v).all()):
            fail("main run model has the wrong shape or is not finite")
        noise_kernel = ("cohort_clip_noise" if dp_rng == "operand"
                        else "cohort_clip_noise_prng")
        other = ("cohort_clip_noise_prng" if dp_rng == "operand"
                 else "cohort_clip_noise")
        for name in (*TICK_PATH, noise_kernel, "cohort_logreg_block"):
            if counts[name] <= 0:
                fail(f"kernel {name} was not launched on the main run "
                     f"({dp_rng})")
        if counts[other] or (dp_rng == "in_kernel" and draws.n):
            fail(f"main run ({dp_rng}) drew noise the other way: "
                 f"{counts}, {draws.n} prng.normal draws")
        ticks = tel.ticks
        print(f"phase main ({dp_rng}): C={m['C']} D={m['d'] + 1} "
              f"rounds={m['rounds']} sizes={kw['sizes']} ticks={ticks} "
              f"ops={tel.ops} fused_iters={eng.fused_iters} "
              f"host_syncs={eng.host_syncs} losses={losses} wall_s={wall} "
              f"noise_ms={noise_ms()} normal_draws={draws.n} "
              f"client_rounds_per_s={m['C'] * m['rounds'] / wall} "
              f"ms_per_tick={1e3 * wall / ticks} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated(dev) / 1e9} "
              f"wall_phases={tel.wall} launches={counts}")
        if dp_rng == "operand":
            eps = [r["epsilon"] for r in (tel.dp or [])
                   if r["epsilon"] is not None]
            print(f"phase main: dp rows={len(tel.dp or [])} "
                  f"max_epsilon={max(eps) if eps else None}")
        out[dp_rng] = counts
        fps[dp_rng] = fingerprint(sim, res)
        if dp_rng == "operand":
            st = eng.local_state
            blocks = dict(task=eng.ltask, w=st.w, U=st.U, calls=calls)
    return out["operand"], fps, blocks


def phase_client_block(dev, blocks):
    """Phase 3 (b): ``cohort_logreg_block`` against its twin at the main
    run's C, D and block, on the main run's own arguments: of its block
    ticks the one with the most distinct ``n`` (then the most steps), its
    i, h (so its sampled rows), step sizes, clip and l2, and the run's
    last ``w`` and ``U`` as rows; then that tick with a ragged ``n``
    planted.  Bit for bit, one launch, idle rows unchanged; its time
    (10-call graph; the ragged n's beside it), its bound (each step's sampled
    row and label and index read, ``w`` and ``U`` read and written once)
    and the twin's time.  Returns its kernels-line row."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.kernels.cohort_block import (logreg_block,
                                                  logreg_block_ref)
    ct, w, U = blocks["task"], blocks["w"], blocks["U"]
    if not blocks["calls"]:
        fail("main run made no client-block call")

    def raggedness(call):
        n = call[2]
        return int(torch.unique(n).numel()), int(n.sum())

    i, h, n, eta, b = max(blocks["calls"], key=raggedness)
    l2, clip = ct.task.l2, ct.task.dp_clip
    idx = ct.sample_idx(i, h, b)
    # and the same tick with a ragged n planted (0, 1 and b among it)
    g = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    n_rag = torch.randint(0, b + 1, n.shape, generator=g, device=dev,
                          dtype=n.dtype)
    n_rag[:3] = torch.tensor([0, 1, b], dtype=n.dtype)
    for tag, nn in (("main", n), ("ragged", n_rag)):
        launches.reset()
        got = ct.run_block(w, U, i, h, nn, eta, b)
        torch.cuda.synchronize()
        if launches.LAUNCHES["cohort_logreg_block"] != 1:
            fail(f"client block ({tag} n) launched cohort_logreg_block "
                 f"{launches.LAUNCHES['cohort_logreg_block']} times, want 1")
        want = logreg_block_ref(w, U, idx, nn, eta, ct.X, ct.y, l2=l2,
                                clip=clip)
        idle = nn <= 0
        for what, k, p, old in zip(("w", "U"), got, want, (w, U)):
            if not bits_equal(k, p):
                fail(f"cohort_logreg_block {what} ({tag} n) is not bitwise "
                     f"equal to its twin at the main run's block tick")
            if not bits_equal(k[idle], old[idle]):
                fail(f"cohort_logreg_block ({tag} n) changed the {what} "
                     f"rows of clients that take no step")
    rag_ms = median_ms(lambda: logreg_block(w, U, idx, n_rag, eta, ct.X,
                                            ct.y, l2=l2, clip=clip))
    C, D = w.shape
    d = D - 1
    steps = int(torch.clamp(n, 0, b).sum())
    distinct = int(torch.unique(n).numel())
    ms = median_ms(lambda: logreg_block(w, U, idx, n, eta, ct.X, ct.y, l2=l2,
                                        clip=clip))
    pms = event_ms(lambda: logreg_block_ref(w, U, idx, n, eta, ct.X, ct.y,
                                            l2=l2, clip=clip), reps=2)
    # per step: the sampled row, its label and index; per client: w and U
    # read and written, n and eta.  Per step and feature: the dot product,
    # the gradient, U and w (6), the clip's norm and scale (3), the l2 term
    # (3)
    per = 6 + (3 if clip > 0.0 else 0) + (3 if l2 > 0.0 else 0)
    bms, by = bound(steps * (4 * d + 4 + 8) + 16 * C * D + 8 * C,
                    steps * d * per)
    print(f"phase client_block: cohort_logreg_block bitwise against its "
          f"twin at C={C} D={D} b={b} steps={steps} (mean n "
          f"{steps / C}, {distinct} distinct n) clip={clip} l2={l2}: "
          f"ms={ms} bound_ms={bms} ({by}) plain_ms={pms}; ragged n "
          f"(0..{b}) bitwise too, ms={rag_ms}")
    return dict(name="cohort_logreg_block", route="cuda",
                source="src/repro_torch/csrc/cohort_block.cu",
                replaces="none (src/repro/cohort/tasks.py:76 block_body, "
                "a vmapped scan)", max_abs_err=0.0, ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, library_ms=None, C=C, D=D, b=b,
                steps=steps, distinct_n=distinct, ragged_ms=rag_ms)


def phase_scenarios(dev, X, y, kw):
    """Phase 4: the main configuration under two scenario presets and
    strategies with in-kernel noise (the slice's path: counts zeroed
    before its first run, read after its last), each repeated with
    operand noise: the integer state must be identical."""
    import torch
    from repro_torch.kernels import launches

    runs, fps = {}, {}
    shares = []
    launches.reset()
    for dp_rng in ("in_kernel", "operand"):
        if dp_rng == "operand":
            path_counts = dict(launches.LAUNCHES)
            launches.reset()
        for sc in SCENARIOS:
            sim = make_sim(dev, X, y, dp_rng=dp_rng, **scenario_kw(sc),
                           **kw)
            eng = sim.engine
            noise_ms = time_noise(eng)
            masked = count_masked(eng) if dp_rng == "in_kernel" else None
            torch.cuda.reset_peak_memory_stats(dev)
            before = dict(launches.LAUNCHES)
            with count_normal_draws() as draws:
                res, wall = timed_run(sim, sc["rounds"], sc["rounds"])
            counts = {k: launches.LAUNCHES[k] - before[k] for k in before}
            fin, tel = res["final"], res["telemetry"]
            if fin["round"] < sc["rounds"]:
                fail(f"{sc['tag']} ({dp_rng}) reached round {fin['round']}")
            if eng.host_syncs["tick"] != tel.ticks:
                fail(f"{sc['tag']} ({dp_rng}): {eng.host_syncs['tick']} "
                     f"host syncs for {tel.ticks} ticks")
            if dp_rng == "in_kernel" and (draws.n
                                          or counts["cohort_clip_noise"]):
                fail(f"{sc['tag']}: in-kernel noise drew operand noise")
            if sc["ring_cap"] is not None and not (
                    eng.F > 0 and fin["far_messages"] > 0):
                fail(f"{sc['tag']}: no far-tier traffic (F={eng.F}, "
                     f"far_messages={fin['far_messages']})")
            loss = fin["loss"]
            if not math.isfinite(loss):
                fail(f"{sc['tag']} ({dp_rng}) loss {loss}")
            print(f"phase scenarios {sc['tag']} ({dp_rng}): C={eng.C} "
                  f"D={eng.D} block={sc['block']} L={eng.L} R={eng.R} "
                  f"F={eng.F} Q={eng.Q} rounds={sc['rounds']} "
                  f"ticks={tel.ticks} wall_s={wall} "
                  f"ms_per_tick={1e3 * wall / tel.ticks} "
                  f"noise_ms={noise_ms()} fused_iters={eng.fused_iters} "
                  f"host_syncs_per_tick="
                  f"{eng.host_syncs['tick'] / tel.ticks} "
                  f"overflow_hwm={fin['overflow_hwm']} "
                  f"overflow_slots={fin['overflow_slots']} "
                  f"far_messages={fin['far_messages']} "
                  f"messages={fin['messages']} ops={tel.ops} loss={loss} "
                  f"peak_mem_gb="
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9} "
                  f"launches={counts}")
            if masked is not None:
                share = [k / eng.C for k in masked()]
                if len(share) != counts["cohort_clip_noise_prng"]:
                    fail(f"{sc['tag']}: {len(share)} noise calls, "
                         f"{counts['cohort_clip_noise_prng']} launches")
                shares += share
                print(f"phase scenarios {sc['tag']} ({dp_rng}): masked "
                      f"share of the cohort_clip_noise_prng launches: "
                      f"mean={statistics.fmean(share)} max={max(share)} "
                      f"min={min(share)} launches={len(share)}")
            runs[(sc["tag"], dp_rng)] = (int_state(eng), eng.fused_iters,
                                         loss)
            if dp_rng == "operand":
                fps[sc["tag"]] = fingerprint(sim, res)
    for name in (*TICK_PATH, "cohort_clip_noise_prng"):
        if path_counts[name] <= 0:
            fail(f"kernel {name} was not launched on the scenario runs")
    for sc in SCENARIOS:
        a, b = runs[(sc["tag"], "in_kernel")], runs[(sc["tag"], "operand")]
        bad = [f for f in a[0] if not torch.equal(a[0][f], b[0][f])]
        if bad or a[1] != b[1]:
            fail(f"{sc['tag']}: integer state differs between in-kernel "
                 f"and operand noise in {bad or 'fused_iters'}")
        print(f"phase scenarios {sc['tag']}: integer state identical "
              f"between noise sources ({len(a[0])} int32 fields); losses "
              f"in_kernel={a[2]} operand={b[2]}")
    print(f"phase scenarios: launches on the in-kernel runs {path_counts}")
    print(f"phase scenarios: masked share of the "
          f"{len(shares)} cohort_clip_noise_prng launches: "
          f"mean={statistics.fmean(shares)} max={max(shares)}")
    return path_counts, fps


# most ticks of a run whose server steps phase server_step records
SERVER_TICKS = 300


def record_server_steps(eng, dmod, rounds: int, ticks: int) -> list:
    """Advance the device engine ``eng`` through ``rounds`` rounds, at
    most ``ticks`` ticks, with its
    ``server_apply`` wrapped: a copy of each call's operands is kept (the
    whole ring and overflow bucket the slot and rows are views of), then
    the call goes on as usual."""
    rec = []
    orig = dmod.server_apply

    def recorder(v, due, dec, has_arr, **kw):
        # the ring [L, A, D] whose slot ``due`` is
        root = due if due._base is None else due._base
        ring = root.reshape(-1, *due.shape)
        slot = (due.data_ptr() - root.data_ptr()) // (4 * due.numel())
        rec.append(dict(
            v=v.clone(), ring=ring.clone(), slot=int(slot), dec=dec.clone(),
            has_arr=has_arr.clone(),
            **{k: (None if kw[k] is None else kw[k].clone())
               for k in ("ovf", "ovf_hit", "buf", "flush", "bc_v",
                         "fired")}))
        return orig(v, due, dec, has_arr, **kw)

    dmod.server_apply = recorder
    try:
        eng.segment(target_k=rounds, tick_limit=ticks)
    finally:
        dmod.server_apply = orig
    return rec


def prep_server_step(r, stratified: bool) -> dict:
    """A copy of a recorded step's operands (ring [L, A, D], overflow
    bucket [Q, A, D]) to run once (in place); under FedAsync with the
    plain ring and overflow bucket beside them, all +0.0, which the
    separate-launch route also resets."""
    import torch
    c = {k: (t if t is None or isinstance(t, int) else t.clone())
         for k, t in r.items()}
    if stratified:
        L, _, D = r["ring"].shape
        dev = r["v"].device
        c["plain_ring"] = torch.zeros((L, D), device=dev)
        c["plain_ovf"] = (None if r["ovf"] is None else
                          torch.zeros((r["ovf"].shape[0], D), device=dev))
    return c


def run_new_step(c):
    """The kernel's step on ``prep_server_step``'s copy; (v', ring, ovf,
    buf, bc_v), the last four written in place."""
    from repro_torch.kernels.tick_fused import server_apply
    v2 = server_apply(c["v"], c["ring"][c["slot"]], c["dec"], c["has_arr"],
                      reset=True, ovf=c["ovf"], ovf_hit=c["ovf_hit"],
                      buf=c["buf"], flush=c["flush"], bc_v=c["bc_v"],
                      fired=c["fired"])
    return v2, c["ring"], c["ovf"], c["buf"], c["bc_v"]


def run_old_step(c):
    """The separate-launch route on ``prep_server_step``'s copy; the same
    tuple, new tensors."""
    return old_server_route(
        c["v"], c["ring"], c["slot"], c["dec"], c["has_arr"], ovf=c["ovf"],
        ovf_hit=c["ovf_hit"], buf=c["buf"], flush=c["flush"],
        bc_v=c["bc_v"], fired=c["fired"], plain_ring=c.get("plain_ring"),
        plain_ovf=c.get("plain_ovf"))


def phase_server_step(dev, X, y, kw):
    """Phase 0: the server step on real ticks.  The device engine runs
    the main run and scenarios (a) and (b), at most SERVER_TICKS ticks
    each (in-kernel noise), with each server step's operands recorded; then
    each recorded step goes through the kernel and through the
    separate-launch route (``old_server_route``) on copies: v' and every
    row bit for bit alike, and the device operations of each route a
    tick counted with ``torch.profiler`` (kernels, copies and fills
    between the probes around the route's steps of one tick kind, in one
    session a run: ``device_ops``), by tick kind.
    Fails unless the kernel's route is one device operation a tick.  Runs
    first, before any other profiler session of the process.  Returns the
    counts."""
    from repro_torch.cohort import device as dmod

    m = MAIN
    runs = [("main", dict(block=m["block"]), m["rounds"])]
    runs += [(sc["tag"], scenario_kw(sc), sc["rounds"]) for sc in SCENARIOS]
    out = {}
    for tag, extra, rounds in runs:
        sim = make_sim(dev, X, y, dp_rng="in_kernel", **extra, **kw)
        eng = sim.engine
        rec = record_server_steps(eng, dmod, rounds, SERVER_TICKS)
        strat = eng.strategy.stratified
        kinds = {}
        for r in rec:
            nf = 0 if r["bc_v"] is None else int(r["fired"].sum())
            key = (f"arr={int(r['has_arr'])} fired={nf}"
                   + (f" hit={int(r['ovf_hit'].any())}"
                      if r["ovf"] is not None else "")
                   + (f" flush={int(r['flush'])}" if r["buf"] is not None
                      else ""))
            kinds.setdefault(key, []).append(r)
        for r in rec:
            new = run_new_step(prep_server_step(r, strat))
            old = run_old_step(prep_server_step(r, strat))
            for name, a, b in zip(("v", "ring", "ovf", "buf", "bc_v"), new,
                                  old):
                if a is not None and not bits_equal(a, b):
                    fail(f"phase server_step {tag}: the kernel's {name} "
                         f"differs from the separate-launch route's")
        routes = (("new", run_new_step), ("old", run_old_step))
        runs = [((lambda rs=rs: [prep_server_step(r, strat) for r in rs]),
                 (lambda pre, step=step: [step(c) for c in pre]))
                for rs in kinds.values() for _, step in routes]
        counts, lost = device_ops(runs, f"phase server_step {tag}")
        per = {}
        for i, (key, rs) in enumerate(kinds.items()):
            cnt = {route: counts[2 * i + j]
                   for j, (route, _) in enumerate(routes)}
            per[key] = dict(ticks=len(rs),
                            new=sum(cnt["new"].values()) / len(rs),
                            old=sum(cnt["old"].values()) / len(rs),
                            old_ops=cnt["old"], new_ops=cnt["new"])
            if per[key]["new"] != 1.0:
                fail(f"phase server_step {tag} {key}: {per[key]['new']} "
                     f"device operations a tick through the kernel: "
                     f"{cnt['new']}")
        n = len(rec)
        mean_old = sum(p["old"] * p["ticks"] for p in per.values()) / n
        print(f"phase server_step {tag}: {n} ticks recorded (F={eng.F}, "
              f"strategy={eng.strategy.kind}); kernel route bit for bit the "
              f"separate-launch route on every tick; device operations a "
              f"tick: kernel 1, separate-launch route {mean_old} on average "
              f"(one profiler session, {lost} discarded); by tick "
              f"kind: " + json.dumps(
                  {k: {f: p[f] for f in ("ticks", "new", "old", "old_ops")}
                   for k, p in per.items()}))
        out[tag] = dict(ticks=n, new=1.0, old=mean_old, kinds=per)
        del sim, eng, rec
    return out


def scenario_kw(sc):
    """The scenario, strategy and block of one of ``SCENARIOS``."""
    import dataclasses
    import repro_torch as rt
    from repro_torch.scenarios import get_scenario
    scn = get_scenario(sc["scenario"])
    if sc["ring_cap"] is not None:
        scn = dataclasses.replace(scn, ring_cap=sc["ring_cap"])
    kind, hp = sc["strategy"]
    strat = (rt.core.FedAsyncStrategy(**hp) if kind == "fedasync"
             else rt.core.FedBuffStrategy(**hp))
    return dict(block=sc["block"], scenario=scn, strategy=strat)


def small_scenario_inputs():
    """Phase 5's case: the reference's overflow scenario (latency U(1, 200)
    s over a ring of 8 ticks) with FedAsync and DP, 6 clients."""
    import repro_torch as rt
    from repro_torch.scenarios import LatencyTable, Scenario
    X, y = rt.make_binary_dataset(300, 12, seed=9, noise=0.3)
    scn = Scenario("tail", LatencyTable.from_uniform(1.0, 200.0, 16),
                   ring_cap=8)
    kw = dict(C=6, sizes=[4, 6], etas=[0.1, 0.08], d=2, seed=2, block=4,
              l2=1.0 / 300, dp_clip=0.1, dp_sigma=2.0, dp_round_clip=0.5,
              sample_seed=21, scenario=scn, strategy="fedasync",
              rounds=3, eval_every=1)
    return X, y, kw


def phase_small_scenario(dev):
    """Phase 5: a small stratified + overflow + DP case (the reference's
    overflow scenario with FedAsync) on the card against the port's
    plain CPU run, with both noise sources."""
    import numpy as np
    import torch

    X, y, kw = small_scenario_inputs()
    for dp_rng in ("in_kernel", "operand"):
        gsim, gpu, wall = run_sim(dev, X, y, dp_rng=dp_rng, **kw)
        csim, cpu, _ = run_sim(torch.device("cpu"), X, y, dp_rng=dp_rng,
                               **kw)
        if gsim.engine.F <= 0 or gpu["final"]["far_messages"] <= 0:
            fail("small scenario case: no far-tier traffic")
        gi, ci = int_state(gsim.engine), int_state(csim.engine)
        bad = [f for f in gi if not torch.equal(gi[f], ci[f])]
        if bad:
            fail(f"small scenario case ({dp_rng}): integer fields {bad} "
                 f"differ between card and CPU")
        lg = np.array([h["loss"] for h in gpu["history"]])
        lc = np.array([h["loss"] for h in cpu["history"]])
        mg = gpu["model"]["w"].cpu().numpy()
        mc = cpu["model"]["w"].numpy()
        if not (np.allclose(lg, lc, rtol=1e-5, atol=1e-7)
                and np.allclose(mg, mc, rtol=1e-5, atol=1e-7)):
            fail(f"small scenario case ({dp_rng}): card {lg} vs CPU {lc}, "
                 f"model off by {float(np.abs(mg - mc).max())}")
        print(f"phase small_scenario_agreement ({dp_rng}): "
              f"far_messages={gpu['final']['far_messages']} "
              f"overflow_hwm={gpu['final']['overflow_hwm']} "
              f"losses card={lg.tolist()} cpu={lc.tolist()} "
              f"max_rel={float(np.max(np.abs(lg - lc) / np.abs(lc)))} "
              f"model_max_abs={float(np.abs(mg - mc).max())} wall_s={wall}")


def fingerprint(sim, res):
    """What two cohort engines must share bit for bit: the integer
    counters and per-client state, the op census, the eval losses and
    the ``w``/``U``/``v`` blocks (kept on the card)."""
    import numpy as np
    import torch
    eng, tel = sim.engine, res["telemetry"]
    st = getattr(eng, "local_state", eng.state)     # a rank's tensors

    def ints(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return x.astype(np.int64).tolist()

    return {
        "ints": {"ticks": tel.ticks, "rounds": tel.rounds,
                 "messages": tel.messages, "broadcasts": tel.broadcasts,
                 "participation": ints(tel.participation),
                 "bytes_up": ints(tel.bytes_up),
                 "staleness_hist": ints(tel.staleness_hist),
                 "overflow_hwm": tel.overflow_hwm,
                 "far_messages": tel.far_messages, "ops": dict(tel.ops),
                 **{f: ints(getattr(st, f))
                    for f in ("i", "h", "k", "credit")}},
        "losses": [h["loss"] for h in res["history"]]
        + [res["final"]["loss"]],
        "blocks": {f: getattr(st, f) for f in ("w", "U", "v")},
    }


def loss_bits(losses):
    """The losses as bytes: equal for equal values, and for NaN from the
    same computation (a DP run whose noise overwhelms the model)."""
    import struct
    return [struct.pack("<d", x) for x in losses]


def same_run(host, device, what: str) -> None:
    """Fail unless the host engine's fingerprint is the device engine's
    (or one device run's another's)."""
    bad = [k for k in device["ints"] if host["ints"][k] != device["ints"][k]]
    if bad:
        fail(f"{what}: integer fields {bad} differ between the two runs")
    if loss_bits(host["losses"]) != loss_bits(device["losses"]):
        fail(f"{what}: losses {host['losses']} vs {device['losses']}")
    for f in ("w", "U", "v"):
        if not bits_equal(host["blocks"][f], device["blocks"][f]):
            fail(f"{what}: {f} differs between the two runs")


HOST_PATH = (*TICK_PATH, "cohort_clip_noise")
# the kernels of phase 13's model-scale cohort runs (rows 1-5)
TRAIN_PATH = HOST_PATH + ("cohort_clip_noise_prng",)


def phase_host_engine(dev, X, y, kw, main_fp, scenario_fps):
    """Phase 10: the host-loop engine at the main configuration, then
    under phase 4's scenarios for one round each, each bit for bit
    against the device engine with operand noise (phase 3's run, phase
    4's where it ran one round, else a one-round device run here).
    Launch counts are zeroed before each host run and read after it;
    returns their sum."""
    from repro_torch.kernels import launches

    m = MAIN
    total = dict.fromkeys(launches.LAUNCHES, 0)
    runs = [("main", dict(block=m["block"]), m["rounds"], m["rounds"] // 2,
             main_fp)]
    for sc in SCENARIOS:
        runs.append((sc["tag"], scenario_kw(sc), 1, 1,
                     scenario_fps[sc["tag"]] if sc["rounds"] == 1 else None))
    for tag, extra, rounds, every, want in runs:
        if want is None:
            dsim = make_sim(dev, X, y, dp_rng="operand", **extra, **kw)
            dres, dwall = timed_run(dsim, rounds, every)
            want = fingerprint(dsim, dres)
            print(f"phase host_engine {tag}: device engine (operand) "
                  f"rounds={rounds} ticks={dres['telemetry'].ticks} "
                  f"wall_s={dwall}")
        sim = make_sim(dev, X, y, host=True, **extra, **kw)
        launches.reset()
        res, wall = timed_run(sim, rounds, every)
        counts = dict(launches.LAUNCHES)
        for k, n in counts.items():
            total[k] += n
        if res["final"]["round"] < rounds:
            fail(f"host_engine {tag} reached round {res['final']['round']}")
        if tag == "main":
            missing = [k for k in HOST_PATH if counts[k] <= 0]
            if missing:
                fail(f"host_engine main: kernels {missing} not launched")
        if counts["cohort_clip_noise_prng"]:
            fail(f"host_engine {tag}: launched the in-kernel noise")
        applies = int(res["telemetry"].ops["bucket_applies"])
        if counts["bucket_apply"] != applies:
            fail(f"host_engine {tag}: {counts['bucket_apply']} server-step "
                 f"launches for {applies} applies")
        same_run(fingerprint(sim, res), want, f"host_engine {tag}")
        tel = res["telemetry"]
        print(f"phase host_engine {tag}: C={sim.engine.C} D={sim.engine.D} "
              f"block={extra['block']} rounds={rounds} ticks={tel.ticks} "
              f"wall_s={wall} ms_per_tick={1e3 * wall / tel.ticks} "
              f"messages={tel.messages} far_messages={tel.far_messages} "
              f"ops={tel.ops} losses={[h['loss'] for h in res['history']]}"
              f" wall_phases={tel.wall} launches={counts} server-step "
              f"launches per apply: 1 ({applies} applies) bitwise against "
              f"the device engine: yes")
    missing = [k for k in HOST_PATH if total[k] <= 0]
    if missing:
        fail(f"host_engine: kernels {missing} not launched")
    print(f"phase host_engine: launches over the host runs {total}")
    return total


# phase 16: the ported examples, each started as users start it, at its
# reference size on the card
EXAMPLES = ("torch_quickstart", "torch_cohort_quickstart",
            "torch_dp_federated", "torch_biased_clients",
            "torch_llm_fl_pretrain")
EXAMPLES_TIMEOUT_S = 300
EXAMPLES_DEVICE = "cuda"


def start_examples(env) -> dict:
    """Start every ported example (default sizes, on the card), all at
    once: they are host-bound Python loops, so they overlap.  Each one's
    output goes to ``build/examples/<name>.txt``."""
    out_dir = os.path.join(HERE, "build", "examples")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in EXAMPLES:
        path = os.path.join(out_dir, f"{name}.txt")
        with open(path, "w") as log:
            procs[name] = (path, subprocess.Popen(
                [sys.executable, os.path.join(HERE, "examples", f"{name}.py"),
                 "--device", EXAMPLES_DEVICE], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def join_examples(procs: dict, t0: float) -> dict:
    """Wait for the examples (all killed past ``EXAMPLES_TIMEOUT_S`` from
    ``t0``, their start); each must exit 0.  Returns each one's wall in
    seconds, from the start to its exit."""
    walls, pending = {}, dict(procs)
    while pending:
        for name, (path, p) in list(pending.items()):
            if p.poll() is not None:
                walls[name] = time.perf_counter() - t0
                del pending[name]
        if time.perf_counter() - t0 > EXAMPLES_TIMEOUT_S:
            for _, p in procs.values():
                p.kill()
            fail(f"examples {sorted(pending)} still running after "
                 f"{EXAMPLES_TIMEOUT_S} s")
        time.sleep(0.05)
    for name, (path, p) in procs.items():
        with open(path) as f:
            out = f.read()
        tail = "\n".join(out.strip().splitlines()[-6:])
        print(f"phase cohort_mesh: example {name} exit={p.returncode} "
              f"wall_s={walls[name]}\n{tail}")
        if p.returncode != 0:
            fail(f"example {name} exited {p.returncode}:\n{out[-3000:]}")
    return walls


def mesh_run(dev, X, y, kw, mesh, what: str, rounds: int, every: int,
             **extra):
    """One device-engine run over ``mesh`` with its collectives logged a
    tick: (sim, res, wall, [(completion tick?, counts)])."""
    sim = make_sim(dev, X, y, mesh=mesh, **extra, **kw)
    eng = sim.engine
    log, tick = [], eng._tick

    def logged(st, t, sk0):
        before = dict(eng.collectives)
        st, p = tick(st, t, sk0)
        log.append((bool(p.any_done),
                    {k: eng.collectives[k] - before[k] for k in before}))
        return st, p

    eng._tick = logged
    res, wall = timed_run(sim, rounds, every)
    if eng.host_syncs["tick"] != res["telemetry"].ticks:
        fail(f"cohort_mesh {what}: {eng.host_syncs['tick']} host syncs for "
             f"{res['telemetry'].ticks} ticks")
    return sim, res, wall, log


def check_placements(eng, mesh, what: str) -> None:
    """Every state field a DTensor on ``mesh`` placed as
    ``cohort_shardings`` says, a view of the rank's tensor."""
    from repro_torch.sharding import cohort_shardings
    st, local = eng.state, eng.local_state
    for f, (_, pl) in cohort_shardings(mesh, eng.C).items():
        t = getattr(st, f)
        if (t.device_mesh != mesh or tuple(t.placements) != tuple(pl)
                or t.to_local().data_ptr() != getattr(local, f).data_ptr()):
            fail(f"cohort_mesh {what}: field {f} placed {t.placements} on "
                 f"{t.device_mesh}, want {pl} on the clients mesh (a view)")


def per_tick(log) -> dict:
    """The most collectives of each kind on a tick with and without
    completions."""
    out = {}
    for done, counts in log:
        k = "completion_tick" if done else "other_tick"
        out[k] = {c: max(n, out.get(k, {}).get(c, 0))
                  for c, n in counts.items()}
    return out


def phase_cohort_mesh(dev, X, y, kw, main_fps):
    """Phase 16: the device engine over a ``clients`` mesh of one NCCL
    rank (the machine has one card): (a) the main run with operand and
    with in-kernel noise, each bit for bit phase main's ``mesh=None`` run
    (``fingerprint``: integers, census, losses as bytes, w / U / v), the
    state's placements ``cohort_shardings``', one host read a tick and
    the collectives a tick printed; (b) phase 5's small overflow +
    FedAsync case over the mesh, bit for bit its ``mesh=None`` run; with
    the ported examples running meanwhile, each as users start it.
    Returns the walls."""
    import torch.distributed as dist
    from repro_torch.kernels import launches
    from repro_torch.launch.mesh import _free_port
    from repro_torch.sharding import cohort_mesh

    t0 = time.perf_counter()
    procs = start_examples(dict(os.environ,
                                PYTHONPATH=os.path.join(HERE, "src")))
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    try:
        mesh = cohort_mesh(dev)
        m = MAIN
        for dp_rng in ("operand", "in_kernel"):
            what = f"(a) main ({dp_rng})"
            launches.reset()
            sim, res, wall, log = mesh_run(
                dev, X, y, kw, mesh, what, m["rounds"], m["rounds"] // 2,
                block=m["block"], dp_rng=dp_rng)
            counts = dict(launches.LAUNCHES)
            eng = sim.engine
            noise = ("cohort_clip_noise" if dp_rng == "operand"
                     else "cohort_clip_noise_prng")
            missing = [k for k in (*TICK_PATH, noise) if counts[k] <= 0]
            if missing:
                fail(f"cohort_mesh {what}: kernels {missing} not launched")
            same_run(fingerprint(sim, res), main_fps[dp_rng],
                     f"cohort_mesh {what}")
            check_placements(eng, mesh, what)
            print(f"phase cohort_mesh {what}: ranks={mesh.size()} "
                  f"cut={eng.axis.sharded} ticks={res['telemetry'].ticks} "
                  f"host_syncs={eng.host_syncs} "
                  f"collectives={eng.collectives} "
                  f"max_collectives_per_tick={per_tick(log)} wall_s={wall} "
                  f"launches={counts}; bit for bit the mesh=None run, "
                  f"placements cohort_shardings'")
        Xs, ys, skw = small_scenario_inputs()
        rounds, every = skw.pop("rounds"), skw.pop("eval_every")
        for dp_rng in ("in_kernel", "operand"):
            what = f"(b) small scenario ({dp_rng})"
            base = make_sim(dev, Xs, ys, dp_rng=dp_rng, **skw)
            bres, _ = timed_run(base, rounds, every)
            sim, res, wall, log = mesh_run(dev, Xs, ys, skw, mesh, what,
                                           rounds, every, dp_rng=dp_rng)
            if sim.engine.F <= 0 or res["final"]["far_messages"] <= 0:
                fail(f"cohort_mesh {what}: no far-tier traffic")
            same_run(fingerprint(sim, res), fingerprint(base, bres),
                     f"cohort_mesh {what}")
            check_placements(sim.engine, mesh, what)
            print(f"phase cohort_mesh {what}: far_messages="
                  f"{res['final']['far_messages']} ticks="
                  f"{res['telemetry'].ticks} max_collectives_per_tick="
                  f"{per_tick(log)} wall_s={wall}; bit for bit the "
                  f"mesh=None run")
        mesh_wall = time.perf_counter() - t0
    finally:
        if own:
            dist.destroy_process_group()
    walls = join_examples(procs, t0)
    total = time.perf_counter() - t0
    print(f"phase cohort_mesh: (a)+(b) wall_s={mesh_wall} examples "
          f"wall_s={walls} phase wall_s={total}")
    return walls


# the event simulator's card run: the three-way-parity configuration of
# the reference (tests/test_cohort_parity.py) at C = 64
EVENT = dict(C=64, sizes=[10, 20, 30, 40], etas=[0.1, 0.08, 0.06, 0.05],
             speeds=[1.0, 0.8, 1.2, 0.9], rounds=4, sample_seed=13)
# event vs cohort: bucketed vs per-message server adds reorder f32 sums
# (the reference's bound).  The event engine on the card against its CPU
# run reorders f32 sums too (the 785-term dot products, exp and log1p
# rounding), compounded over 100 SGD steps a client: the same bound.
# At this width the port's CPU run is 4.1e-5 off the reference's own
# (max |w| 8.8), and an H100 run 2.3e-5 off the CPU run
EVENT_ATOL = 1e-4


def event_setup(X, y):
    """The event phase's task and simulator keywords (``EVENT``)."""
    import numpy as np
    import repro_torch as rt
    e = EVENT
    C = e["C"]
    kw = dict(n_clients=C, sizes_per_client=[e["sizes"]] * C,
              round_stepsizes=e["etas"], d=1, seed=0,
              speeds=list(np.tile(e["speeds"], C // len(e["speeds"]))))
    task = rt.LogRegTask(X, y, l2=1.0 / X.shape[0],
                         sample_seed=e["sample_seed"])
    return task, kw


def phase_event(dev, X, y):
    """Phase 11: the event simulator on the card against both cohort
    engines on the card (three-way parity at d = 1) and against its own
    CPU run."""
    import torch
    import repro_torch as rt

    e = EVENT
    C = e["C"]
    task, kw = event_setup(X, y)
    out = {}
    for name, cls, where in (("event", rt.AsyncFLSimulator, dev),
                             ("host", rt.CohortSimulator, dev),
                             ("device", rt.DeviceCohortSimulator, dev),
                             ("event_cpu", rt.AsyncFLSimulator,
                              torch.device("cpu"))):
        sim = cls(task, **kw, device=where)
        res, wall = timed_run(sim, e["rounds"], 1)
        tel = res["telemetry"]
        out[name] = dict(
            ints={"round": res["final"]["round"], "messages": tel.messages,
                  "broadcasts": tel.broadcasts,
                  "participation": tel.participation.tolist(),
                  "staleness_hist": tel.staleness_hist.tolist()},
            model=torch.cat([res["model"]["w"].reshape(-1),
                             res["model"]["b"].reshape(1)]).cpu(),
            wall=wall)
        print(f"phase event: {name} C={C} D={X.shape[1] + 1} "
              f"rounds={e['rounds']} wall_s={wall} "
              f"messages={tel.messages} broadcasts={tel.broadcasts}")
    ev = out["event"]
    if ev["ints"]["round"] != e["rounds"]:
        fail(f"event: reached round {ev['ints']['round']}")
    for name in ("host", "device", "event_cpu"):
        if out[name]["ints"] != ev["ints"]:
            fail(f"event: integers differ from the {name} run: "
                 f"{out[name]['ints']} vs {ev['ints']}")
    if not bits_equal(out["host"]["model"], out["device"]["model"]):
        fail("event: the two cohort engines' models differ on the card")
    gap = float((ev["model"] - out["device"]["model"]).abs().max())
    if not gap < EVENT_ATOL:
        fail(f"event: model off the cohort engines' by {gap}")
    cpu_gap = float((ev["model"] - out["event_cpu"]["model"]).abs().max())
    if not cpu_gap < EVENT_ATOL:
        fail(f"event: card vs CPU model off by {cpu_gap}")
    print(f"phase event: integers equal across event / host / device / "
          f"event on the CPU {ev['ints']['round']} rounds "
          f"{ev['ints']['messages']} messages; event vs cohort max_abs="
          f"{gap} (limit {EVENT_ATOL}); cohort engines bitwise; event "
          f"card vs CPU max_abs={cpu_gap} (limit {EVENT_ATOL}); max |w|="
          f"{float(ev['model'].abs().max())}; event wall_s={ev['wall']} "
          f"cohort host wall_s={out['host']['wall']} device wall_s="
          f"{out['device']['wall']}")


def timed_calls(fn, name: str, per_call: int, what: str, n: int = 3):
    """Call ``fn`` ``n`` times, each ended by a device sync: returns (the
    walls in s, the last result).  Fails unless each call launched kernel
    ``name`` exactly ``per_call`` times.  The first call carries the
    one-time set-up (library handles, the kernel's first launch)."""
    import torch
    from repro_torch.kernels import launches
    walls = []
    for _ in range(n):
        before = launches.LAUNCHES[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = launches.LAUNCHES[name] - before
        if got != per_call:
            fail(f"{what}: {got} {name} launches in one call, want "
                 f"{per_call}")
    return walls, out


def layer_cfg(name: str):
    """A one-layer copy of a supported model config (depth cut only)."""
    import dataclasses
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return dataclasses.replace(mod.config(), n_layers=1)


def attn_pairs(S: int, window) -> int:
    """(query, key) pairs the causal mask (and window) keeps."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attn_flops(B: int, S: int, H: int, hd: int, window) -> float:
    """2 flops per multiply-add of QK^T and PV over the kept pairs."""
    return 4.0 * B * H * hd * attn_pairs(S, window)


def ssd_flops(b: int, s: int, h: int, p: int, n: int, Q: int) -> float:
    """Per (batch, chunk of Q steps): C B^T over the Q (Q + 1) / 2 causal
    pairs, once (B and C have one group: the same for every head); per
    (batch, chunk, head): the diagonal block product over those pairs,
    the off-diagonal term C H and the state update B^T x (2 flops per
    multiply-add)."""
    pairs = Q * (Q + 1) // 2
    nc = -(-s // Q)
    return b * nc * (2.0 * pairs * n
                     + h * (2.0 * pairs * p + 4.0 * Q * n * p))


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref| (the reference suite's SSD rule)."""
    d = (out.float() - ref.float()).abs().max()
    return float(d / (ref.float().abs().max() + 1e-9))


def rel_l2(out, ref):
    """||out - ref||_2 / ||ref||_2 over the whole tensor, and its largest
    value over the rows of the last axis."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    d = o - r
    rows = d.norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)
    return float(d.norm() / r.norm()), float(rows.max())


def check_rel_l2(out, ref, what):
    """Fails unless bf16 ``out`` is within ATTN_BF16_REL_L2 of ``ref``
    whole and ATTN_BF16_ROW_REL_L2 in every row; returns both readings."""
    whole, row = rel_l2(out, ref)
    if not (whole <= ATTN_BF16_REL_L2 and row <= ATTN_BF16_ROW_REL_L2):
        fail(f"{what}: rel L2 {whole} whole (limit {ATTN_BF16_REL_L2}), "
             f"{row} in the worst row (limit {ATTN_BF16_ROW_REL_L2})")
    return whole, row


def check_attention(q, k, v, what, **kw):
    """attend (the kernel on the card) against attention_ref, twice for
    identical bits, and in bf16 also by rel L2; returns the max abs
    error and the two rel L2 readings (whole, worst row)."""
    import torch
    from repro_torch.kernels.flash_attention import attend, attention_ref
    o1 = attend(q, k, v, **kw)
    o2 = attend(q, k, v, **kw)
    p = attention_ref(q, k, v, **kw)
    if not bits_equal(o1.float(), o2.float()):
        fail(f"flash_attention ({what}): two launches differ")
    tol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    diff = (o1.float() - p.float()).abs()
    if not bool((diff <= tol + tol * p.float().abs()).all()):
        fail(f"flash_attention ({what}) off by {float(diff.max())} "
             f"(> {tol} abs + rel)")
    if q.dtype == torch.bfloat16:
        whole, row = check_rel_l2(o1, p, f"flash_attention ({what})")
    else:
        whole, row = rel_l2(o1, p)
    return float(diff.max()), whole, row


def planted_tile_drop(q, k, v, **kw):
    """rel L2 readings of a planted fault against attention_ref: the
    kernel's output with its last 128-row q tile attending without the
    64 keys at S/2 (attention_ref of the sequence with those positions
    cut out: exact for causal attention without a window)."""
    import torch
    from repro_torch.kernels.flash_attention import attend, attention_ref
    S, a = q.shape[1], q.shape[1] // 2

    def cut(t):
        return torch.cat([t[:, :a], t[:, a + 64:]], dim=1)

    faulty = attend(q, k, v, **kw)
    faulty[:, S - 128:] = attention_ref(cut(q), cut(k), cut(v),
                                        **kw)[:, S - 192:]
    return rel_l2(faulty, attention_ref(q, k, v, **kw))


def planted_carry_drop(x, dt, A, B, C, chunk):
    """rel_err against ssd_chunked of a planted fault: the kernel's y with
    its last chunk replaced by ssd_chunked of that chunk alone from a
    zero state (the carry across chunks dropped)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    t0 = (x.shape[1] - 1) // chunk * chunk
    faulty = ssd_scan(x, dt, A, B, C, chunk)[0].clone()
    faulty[:, t0:] = ssd_chunked(x[:, t0:], dt[:, t0:], A, B[:, t0:],
                                 C[:, t0:], chunk)[0]
    return rel_err(faulty, ssd_chunked(x, dt, A, B, C, chunk)[0])


def ssd_phase_ms(x, dt, A, B, C, chunk):
    """Median time of each of the SSD's four kernels alone, on the
    workspaces of one whole launch (not counted: a breakdown of the
    kernel's time)."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as ssd_k
    ops = ssd_k._operands(x, dt, A, B, C, chunk, None)
    b, s, h, p, n, _, _ = ops[-1]
    ws = ssd_k._workspaces(ops[-1], x.device)
    y = torch.empty((b, s, h, p), dtype=ops[0].dtype, device=x.device)
    final = torch.empty((b, h, n, p), device=x.device)
    ssd_k._run(ops, ws, y, final, sum(ssd_k.PHASES.values()))
    return {name: median_ms(lambda: ssd_k._run(ops, ws, y, final, mask))
            for name, mask in ssd_k.PHASES.items()}


def check_ssd(x, dt, A, B, C, chunk, what, h0=None):
    """ssd_scan (the kernel on the card) against ssd_chunked: y and the
    final state within SSD_TOL of max |ref|; returns (y err, state err)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    y1, f1 = ssd_scan(x, dt, A, B, C, chunk, h0)
    y2, f2 = ssd_scan(x, dt, A, B, C, chunk, h0)
    yr, fr = ssd_chunked(x, dt, A, B, C, chunk, h0)
    if not (bits_equal(y1.float(), y2.float()) and bits_equal(f1, f2)):
        fail(f"ssd_scan ({what}): two launches differ")
    tol = SSD_TOL[str(x.dtype).split(".")[-1]]
    ey, ef = rel_err(y1, yr), rel_err(f1, fr)
    if not (ey < tol and ef < tol):
        fail(f"ssd_scan ({what}): y off by {ey}, final state by {ef} of "
             f"max |ref| (limit {tol})")
    return ey, ef


def ptxas_report(log: str, kernel: str):
    """The ptxas lines (registers, spills) of every instantiation of
    ``kernel`` in an nvcc ``-Xptxas=-v`` log, each as (instantiation,
    line), e.g. ``fa_f32_kernel<256>`` or ``ssd_cb_kernel<bf16>``."""
    import re
    args = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out, take = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = None
            m = re.search(re.escape(kernel) + r"(?:I(?:Li(\d+)|(f|13__nv_bfloat16))E)?", line)
            if m:
                arg = m.group(1) or args.get(m.group(2) or "", "")
                take = f"{kernel}<{arg}>" if arg else kernel
        elif take and ("Used" in line or "spill" in line):
            out.append((take, line.strip()))
    return out


def spill_bytes(report) -> int:
    """Spill stores and loads, in bytes, summed over ptxas_report lines."""
    import re
    return sum(int(v) for _, line in report
               for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))


def hgmma_count(name: str):
    """Count of HGMMA (wgmma) instructions in the SASS of the built
    ``lib<name>.so``, or None when the toolkit has no cuobjdump."""
    import shutil
    from repro_torch import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


def phase_model_kernels(dev, G, logs):
    """Phase 6: the model-scale kernels against their plain versions at
    the paths' shapes (``G``: the DP round's per-example gradients) and
    at ragged edge shapes; returns their JSON entries.  ``logs``: the
    nvcc logs of the sources built by this run (``build_all``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.kernels.dp_clip import (clip_accumulate,
                                             clip_accumulate_ref,
                                             clip_accumulate_twin)
    from repro_torch.kernels.flash_attention import attend, attention_ref
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    f32, bf16 = torch.float32, torch.bfloat16
    out = []

    # -- clip_accumulate ---------------------------------------------------
    clip = fl_config_fig1b().dp.clip_norm

    def check_clip(Gm, what):
        k1 = clip_accumulate(Gm, clip=clip)
        k2 = clip_accumulate(Gm, clip=clip)
        p = clip_accumulate_ref(Gm, clip)
        if not bits_equal(k1, k2):
            fail(f"clip_accumulate ({what}): two launches differ")
        if not bits_equal(k1.cpu(), clip_accumulate_twin(Gm.cpu(), clip)):
            fail(f"clip_accumulate ({what}) is not bitwise equal to its "
                 f"order-exact twin")
        tol = SUM_RTOL * clip_accumulate_ref(Gm.abs(), clip)  # sum|terms|
        diff = (k1 - p).abs()
        if not bool((diff <= tol + 1e-30).all()):
            fail(f"clip_accumulate ({what}) off by {float(diff.max())} "
                 f"(> {SUM_RTOL} * sum|terms|)")
        return float(diff.max())

    N, D = G.shape
    Gmb = G[:DP_MICROBATCH]                     # the first microbatch's
    err = check_clip(G, f"N={N} D={D}")
    check_clip(Gmb, f"N={DP_MICROBATCH} D={D}")
    edges = []
    # the tiles (12 rows f32, 24 bf16) +- 1, the column slab (1024) + 1,
    # and a base pointer off its 16-byte line (a row view)
    for (n, d) in ((1, 1), (37, 13), (4, 300), (130, 785), (11, 785),
                   (13, 785), (25, 785), (40, 1025)):
        for dt in (f32, bf16):
            edges.append(check_clip((3.0 * randn(n, d)).to(dt),
                                    f"N={n} D={d} {dt}"))
            edges.append(check_clip((3.0 * randn(n + 1, d)).to(dt)[1:],
                                    f"N={n} D={d} {dt} row view"))
    planted = clip_planted_drop(G, clip, clip_accumulate_ref(G, clip))
    print(f"phase model_kernels: clip_accumulate planted fault (a block "
          f"partial left out of the finish pass): max diff / limit = "
          f"{planted}")
    if not planted > 1.0:
        fail("clip_accumulate: SUM_RTOL passes a dropped block partial")
    print_ptxas("clip_accumulate", logs.get("dp_clip", ""),
                ("clip_rows_kernel", "clip_norms_kernel", "finish_kernel"))
    times = {}
    for Gm in (G, Gmb, G.to(bf16)):
        n = Gm.shape[0]
        ms = median_ms(lambda: clip_accumulate(Gm, clip=clip))
        pms = median_ms(lambda: clip_accumulate_ref(Gm, clip))
        passes = kernel_ms(lambda: clip_accumulate(Gm, clip=clip))
        bms, by = clip_bound(n, D, Gm.element_size())
        times[(n, Gm.dtype)] = (ms, pms, bms, by)
        print(f"phase model_kernels: clip_accumulate N={n} D={D} "
              f"{Gm.dtype} ms={ms} passes_ms={passes} plain_ms={pms} "
              f"bound_ms={bms} ({by})")
    print(f"phase model_kernels: clip_accumulate max_abs_err={err} "
          f"edges_max_abs_err={max(edges)}")
    ms, pms, bms, by = times[(N, f32)]
    ms6, pms6, bms6, _ = times[(DP_MICROBATCH, f32)]
    out.append(dict(name="clip_accumulate", route="cuda",
                    source="src/repro_torch/csrc/dp_clip.cu",
                    replaces="src/repro/kernels/dp_clip/kernel.py:47",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None, ms_n6000=ms6,
                    plain_n6000_ms=pms6, bound_n6000_ms=bms6,
                    ms_bf16=times[(N, bf16)][0],
                    bound_bf16_ms=times[(N, bf16)][2]))

    # -- flash_attention at gemma2-2b's layer ------------------------------
    # the registers / spills of both kernels (f32: none may spill), and the
    # wgmma instructions of the bf16 one (tensor cores) in the library
    fa_log = logs.get("flash_attention", "")
    f32_rep = ptxas_report(fa_log, "fa_f32_kernel")
    for take, line in (f32_rep + ptxas_report(fa_log, "fa_bf16_kernel")
                       or [("flash_attention", "(library cached: no ptxas "
                                               "report)")]):
        print(f"phase model_kernels: flash_attention ptxas: {take}: {line}")
    if spill_bytes([r for r in f32_rep if r[0] == "fa_f32_kernel<256>"]):
        fail("flash_attention: the f32 kernel at hd 256 spills registers")
    n_hgmma = hgmma_count("flash_attention")
    if n_hgmma is None:
        print("phase model_kernels: flash_attention: cuobjdump missing, "
              "HGMMA count not taken")
    else:
        print(f"phase model_kernels: flash_attention HGMMA instructions in "
              f"the library's SASS: {n_hgmma}")
        if n_hgmma == 0:
            fail("flash_attention: no HGMMA instruction in the library: "
                 "the bf16 path is not on the tensor cores")
    cfg = layer_cfg("gemma2_2b")
    B, S = ATTN["B"], ATTN["S"]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap, W = cfg.attn_softcap, cfg.sliding_window
    entry = None
    for dt in (f32, bf16):
        q, k, v = (randn(B, S, h, hd).to(dt) for h in (H, KV, KV))
        # a global layer of the model passes window = S (layer_windows):
        # the kernel must read any window >= S as plain causal, bit for bit
        causal = attend(q, k, v, softcap=cap)
        for wide in (S, 2 * S):
            if not bits_equal(attend(q, k, v, window=wide, softcap=cap),
                              causal):
                fail(f"flash_attention ({dt}): window={wide} at S={S} is "
                     f"not bitwise the causal output")
        del causal
        for window in (None, W):
            kw = dict(window=window, softcap=cap)
            e, whole, row = check_attention(
                q, k, v, f"S={S} window={window} {dt}", **kw)
            ms = median_ms(lambda: attend(q, k, v, **kw))
            fl = attn_flops(B, S, H, hd, window)
            nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * q.element_size()
            bms, by = bound(nbytes, fl)
            tc_ms = 1e3 * fl / BF16_TC_FLOPS
            print(f"phase model_kernels: flash_attention {dt} B={B} S={S} "
                  f"H={H} KV={KV} hd={hd} softcap={cap} window={window} "
                  f"ms={ms} flops={fl} bound_f32_ms={bms} ({by}) "
                  f"bound_bf16_tensor_core_ms={tc_ms} "
                  f"bytes_ms={1e3 * nbytes / HBM_BYTES_PER_S} "
                  f"max_abs_err={e} rel_l2={whole} worst_row_rel_l2={row}")
            if dt == f32 and window is None:
                pms = median_ms(lambda: attention_ref(q, k, v, **kw),
                                n=3, reps=3)
                entry = dict(name="flash_attention", route="cuda",
                             source="src/repro_torch/csrc/flash_attention.cu",
                             replaces="src/repro/kernels/flash_attention/"
                                      "kernel.py:92",
                             max_abs_err=e, ms=ms, plain_ms=pms,
                             bound_ms=bms, bound_by=by)
            if dt == bf16 and window is None:
                # the bf16 kernel against the bf16 tensor cores' bound
                pms = median_ms(lambda: attention_ref(q, k, v, **kw),
                                n=3, reps=3)
                entry.update(ms_bf16=ms, bound_bf16_ms=tc_ms,
                             tensor_core_share=tc_ms / ms)
                print(f"phase model_kernels: flash_attention bf16 global "
                      f"tensor_core_share={tc_ms / ms} plain_ms={pms}")
                # the rel L2 limits must catch one dropped kv tile
                whole, row = planted_tile_drop(q, k, v, **kw)
                print(f"phase model_kernels: flash_attention bf16 global "
                      f"planted fault (last q tile without the 64 keys at "
                      f"S/2): rel_l2={whole} worst_row_rel_l2={row}")
                if whole <= ATTN_BF16_REL_L2 and row <= ATTN_BF16_ROW_REL_L2:
                    fail("flash_attention: the bf16 rel L2 limits pass a "
                         "dropped kv tile")
        # no single PyTorch call has the softcap: time the library call
        # and the kernel with the softcap off (global layer, causal, GQA)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True).transpose(1, 2)
        nocap = attend(q, k, v)
        e_lib = float((nocap.float() - lib.float()).abs().max())
        tol = ATTN_TOL[str(dt).split(".")[-1]]
        if not bool(((nocap.float() - lib.float()).abs()
                     <= tol + tol * lib.float().abs()).all()):
            fail(f"flash_attention (softcap off, {dt}) off the library "
                 f"call by {e_lib}")
        ms_nocap = median_ms(lambda: attend(q, k, v))
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        print(f"phase model_kernels: flash_attention {dt} softcap off "
              f"global: kernel_ms={ms_nocap} "
              f"scaled_dot_product_attention_ms={lib_ms} "
              f"max_abs_diff={e_lib}")
        if dt == f32:
            entry["library_ms"] = lib_ms
        else:
            entry["library_bf16_ms"] = lib_ms
        del q, k, v, qt, kt, vt, lib, nocap
    edges = [
        check_attention(*(randn(2, 200, h, 64) for h in (4, 2, 2)),
                        "non-causal S=200", causal=False),
        # the f32 kernel's tiles: 64-row q tiles, 256-key kv tiles
        check_attention(*(randn(1, 63, h, 8) for h in (4, 2, 2)),
                        "S=63 hd=8"),
        check_attention(*(randn(1, 65, h, 100) for h in (2, 1, 1)),
                        "S=65 hd=100 KV=1 softcap 50", softcap=50.0),
        check_attention(*(randn(2, 255, h, 256) for h in (4, 1, 1)),
                        "S=255 hd=256 KV=1 window 100", window=100),
        check_attention(*(randn(1, 257, h, 256) for h in (4, 2, 2)),
                        "S=257 hd=256 window 9 softcap 30", window=9,
                        softcap=30.0),
        check_attention(*(randn(2, 200, h, 64).to(bf16) for h in (4, 2, 2)),
                        "non-causal S=200 bf16", causal=False),
        check_attention(*(randn(1, 130, h, 128) for h in (4, 1, 1)),
                        "MQA S=130 window 64 softcap 30", window=64,
                        softcap=30.0),
        check_attention(*(randn(1, 77, 2, 32).to(bf16) for _ in range(3)),
                        "S=77 hd=32 bf16 softcap 50", softcap=50.0),
        check_attention(*(randn(2, 256, 8, 256) for _ in range(3)),
                        "MHA S=256 hd=256 window 100", window=100),
    ]
    # shapes the bf16 kernel's tiles make hard: S around the 128-row q
    # tile, hd not a multiple of 16 (zero fill), KV = 1, a window below
    # the 64-key tile
    for (b_, s_, h_, kv_, hd_, kw) in (
            (1, 1, 4, 2, 64, {}), (2, 129, 4, 2, 128, {}),
            (1, 127, 4, 2, 64, {"causal": False}), (1, 100, 2, 1, 8, {}),
            (1, 150, 4, 2, 100, {"softcap": 30.0}), (1, 200, 8, 1, 64, {}),
            (1, 300, 4, 2, 64, {"window": 9}),
            (1, 1024, 8, 4, 256, {"window": 300, "softcap": 50.0})):
        edges.append(check_attention(
            *(randn(b_, s_, h, hd_).to(bf16) for h in (h_, kv_, kv_)),
            f"bf16 B={b_} S={s_} H={h_} KV={kv_} hd={hd_} {kw}", **kw))
    print(f"phase model_kernels: flash_attention edges max_abs_err="
          f"{max(e[0] for e in edges)} worst_row_rel_l2="
          f"{max(e[2] for e in edges)}")
    out.append(entry)

    # -- ssd_scan at mamba2-780m's mixer -----------------------------------
    ssd_log = logs.get("ssd_scan", "")
    for kern in ("ssd_cb_kernel", "ssd_chunk_state_kernel",
                 "ssd_state_passing_kernel", "ssd_chunk_scan_kernel"):
        for take, line in ptxas_report(ssd_log, kern) or [
                (kern, "(library cached: no ptxas report)")]:
            print(f"phase model_kernels: ssd_scan ptxas: {take}: {line}")
    cfg = layer_cfg("mamba2_780m")
    b, s = SSM["B"], SSM["S"]
    h, p, n, Q = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_chunk)

    def ssd_inputs(b, s, h, p, n, dt, a=None):
        x = randn(b, s, h, p).to(dt)
        dts = F.softplus(randn(b, s, h))
        A = -torch.exp(0.1 * randn(h)) if a is None \
            else torch.full((h,), a, device=dev)
        return x, dts, A, randn(b, s, n).to(dt), randn(b, s, n).to(dt)

    for dt in (f32, bf16):
        args = ssd_inputs(b, s, h, p, n, dt)
        ey, ef = check_ssd(*args, Q, f"b={b} s={s} {dt}")
        ms = median_ms(lambda: ssd_scan(*args, Q))
        fl = ssd_flops(b, s, h, p, n, Q)
        esz = args[0].element_size()
        # read x, dt, A, B, C once; write y and the final state once
        nbytes = (2 * b * s * h * p * esz + 4 * b * s * h + 4 * h
                  + 2 * b * s * n * esz + 4 * b * h * n * p)
        bms, by = bound(nbytes, fl)
        print(f"phase model_kernels: ssd_scan {dt} b={b} s={s} h={h} p={p} "
              f"n={n} chunk={Q} ms={ms} flops={fl} bound_ms={bms} ({by}) "
              f"bytes_ms={1e3 * nbytes / HBM_BYTES_PER_S} y_rel_err={ey} "
              f"state_rel_err={ef} phases_ms={ssd_phase_ms(*args, Q)}")
        if dt == f32:
            pms = median_ms(lambda: ssd_chunked(*args, Q), n=3, reps=3)
            y1, f1 = ssd_scan(*args, Q)
            yr, fr = ssd_chunked(*args, Q)
            err = max(float((y1 - yr).abs().max()),
                      float((f1 - fr).abs().max()))
            # SSD_TOL must catch the carry across chunks dropped in the
            # last chunk
            planted = planted_carry_drop(*args, Q)
            print(f"phase model_kernels: ssd_scan {dt} planted fault (last "
                  f"chunk without the carry): y_rel_err={planted} (limit "
                  f"{SSD_TOL['float32']})")
            if not planted > SSD_TOL["float32"]:
                fail("ssd_scan: SSD_TOL passes the carry dropped from the "
                     "last chunk")
            out.append(dict(name="ssd_scan", route="cuda",
                            source="src/repro_torch/csrc/ssd_scan.cu",
                            replaces="src/repro/kernels/ssd_scan/kernel.py:68",
                            max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=bms, bound_by=by, library_ms=None))
        del args
    edges = [
        check_ssd(*ssd_inputs(1, 100, 2, 32, 16, f32), 64, "s=100 chunk 64"),
        check_ssd(*ssd_inputs(2, 192, 3, 32, 64, bf16), 64, "bf16 s=192"),
        check_ssd(*ssd_inputs(2, 130, 3, 64, 128, f32), 128,
                  "s=130 initial state", h0=randn(2, 3, 128, 64)),
        check_ssd(*ssd_inputs(1, 50, 2, 64, 12, f32), 128, "s=50 < chunk"),
        # the chunk-parallel kernels: mamba2's heads at 2 chunks + 1, one
        # chunk, p = 32, decay underflowing to 0
        check_ssd(*ssd_inputs(1, 257, 48, 64, 128, f32), 128,
                  "h=48 s=257 initial state", h0=randn(1, 48, 128, 64)),
        check_ssd(*ssd_inputs(2, 128, 4, 32, 128, bf16), 128,
                  "bf16 nc=1 p=32"),
        check_ssd(*ssd_inputs(1, 300, 3, 64, 128, f32, a=-8.0), 128,
                  "A=-8 s=300"),
    ]
    print(f"phase model_kernels: ssd_scan edges (y, state) rel errors "
          f"{edges}")
    return out


def phase_dp_round(dev, X, y):
    """Phase 7: the example-level DP-SGD round on the main run's data,
    whole and in microbatches, on the card against the same call on the
    CPU (same key, same noise); returns the per-example gradients and
    the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.configs import fl_config_fig1b
    from repro_torch.dp import dp_sgd_round
    from repro_torch.kernels import launches
    from repro_torch.kernels.dp_clip import clip_accumulate_ref
    from repro_torch.models import logreg

    dp = fl_config_fig1b().dp
    clip, sigma = dp.clip_norm, dp.sigma
    n, d = X.shape
    cpu = torch.device("cpu")
    key = prng.PRNGKey(MAIN["seed"])

    def loss_fn(p, ex):
        return logreg.per_example_loss(p, ex[0], ex[1])

    def inputs(device):
        params = logreg.init_params(d, prng.PRNGKey(0), device=device)
        return params, (torch.as_tensor(X, device=device),
                        torch.as_tensor(y, device=device))

    params, batch = inputs(dev)
    params_c, batch_c = inputs(cpu)
    # the per-example gradients (b first, then w: jax's leaf order), for
    # the tolerance here and the kernel check at this shape
    gw, gb = logreg.per_example_grad(params["w"][None], params["b"][None],
                                     batch[0], batch[1])
    G = torch.cat([gb[:, None], gw], dim=1).contiguous()
    terms = clip_accumulate_ref(G.abs(), clip).cpu()      # sum|terms| per d
    keys = prng.split(key, 2)
    noise = torch.cat([prng.normal(keys[0], (1,)),
                       prng.normal(keys[1], (d,))])
    # card vs CPU: the clipped sums reorder their adds (SUM_RTOL), the
    # normals differ by a few ulp of the libraries' log1p (8 ulp allowed)
    tol = SUM_RTOL * terms + 8 * 2.0 ** -23 * clip * sigma * noise.abs()

    launches.reset()
    split = {}
    for mb, want in ((0, 1), (DP_MICROBATCH, n // DP_MICROBATCH)):
        before = launches.LAUNCHES["clip_accumulate"]
        walls, (U, loss) = timed_calls(
            lambda: dp_sgd_round(loss_fn, params, batch, clip_norm=clip,
                                 sigma=sigma, rng=key, microbatch=mb),
            "clip_accumulate", want, f"dp_round (microbatch={mb})")
        split[f"launches_n{mb or n}"] = (launches.LAUNCHES["clip_accumulate"]
                                         - before)
        Uc, loss_c = dp_sgd_round(loss_fn, params_c, batch_c, clip_norm=clip,
                                  sigma=sigma, rng=key, microbatch=mb)
        u = torch.cat([U["b"].reshape(1), U["w"]]).cpu()
        uc = torch.cat([Uc["b"].reshape(1), Uc["w"]])
        if tuple(U["w"].shape) != (d,) or not bool(torch.isfinite(u).all()):
            fail(f"dp_round (microbatch={mb}): U has the wrong shape or is "
                 f"not finite")
        diff = (u - uc).abs()
        if not bool((diff <= tol).all()):
            fail(f"dp_round (microbatch={mb}): U off the CPU's by "
                 f"{float(diff.max())}")
        lg, lc = float(loss), float(loss_c)
        if not np.isclose(lg, lc, rtol=1e-5, atol=0.0):
            fail(f"dp_round (microbatch={mb}): mean loss {lg} vs CPU {lc}")
        print(f"phase dp_round (microbatch={mb}): N={n} D={d + 1} "
              f"clip={clip} sigma={sigma} launches_per_call={want} "
              f"walls_s={walls} "
              f"mean_loss card={lg} cpu={lc} U_max_abs_diff="
              f"{float(diff.max())} |U|_2={float(u.norm())}")
    return G, dict(launches.LAUNCHES), split


def phase_attention_layer(dev):
    """Phase 8: one gemma2-2b attention layer at full width, local and
    global, f32 and bf16: through the kernel against the same layer
    through the reference's dense core, on the card."""
    import torch
    from repro_torch import convert, prng
    from repro_torch.kernels import launches
    from repro_torch.models.attention import (attend_full, dense_attention,
                                              init_attention)

    cfg = layer_cfg("gemma2_2b")
    B, S = ATTN["B"], ATTN["S"]
    g = torch.Generator(device=dev).manual_seed(2)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    launches.reset()
    for dt in (torch.float32, torch.bfloat16):
        lp = convert.layer(init_attention(cfg, prng.PRNGKey(3), dt,
                                          device=dev), 0)
        x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(dt)
        # layer 0 of gemma2 is local (sliding window), layer 1 global
        for layer_idx in (0, 1):
            window = cfg.sliding_window if cfg.layer_is_local(layer_idx) \
                else None
            what = f"attention_layer ({dt}, window={window})"
            walls, out = timed_calls(
                lambda: attend_full(cfg, lp, x, pos, window),
                "flash_attention", 1, what)
            pwalls, plain = timed_calls(
                lambda: attend_full(cfg, lp, x, pos, window,
                                    core=dense_attention),
                "flash_attention", 0, what + " dense core")
            if tuple(out.shape) != (B, S, cfg.d_model) or not bool(
                    torch.isfinite(out.float()).all()):
                fail(f"attention_layer ({dt}, window={window}): output "
                     f"shape {tuple(out.shape)} or not finite")
            tol = ATTN_TOL[str(dt).split(".")[-1]]
            diff = (out.float() - plain.float()).abs()
            if not bool((diff <= tol + tol * plain.float().abs()).all()):
                fail(f"attention_layer ({dt}, window={window}): off the "
                     f"dense core by {float(diff.max())}")
            if dt == torch.bfloat16:
                whole, row = check_rel_l2(out, plain, what)
            else:
                whole, row = rel_l2(out, plain)
            route = ("tensor cores (wgmma)" if dt == torch.bfloat16
                     else "f32 pipes")
            print(f"phase attention_layer ({dt}, window={window}): B={B} "
                  f"S={S} kernel_route={route} d_model={cfg.d_model} "
                  f"H={cfg.n_heads} "
                  f"KV={cfg.n_kv_heads} hd={cfg.head_dim} "
                  f"softcap={cfg.attn_softcap} walls_s={walls} "
                  f"dense_core_walls_s={pwalls} max_abs_diff="
                  f"{float(diff.max())} max_abs_out="
                  f"{float(plain.float().abs().max())} rel_l2={whole} "
                  f"worst_row_rel_l2={row}")
        del lp, x, out, plain
    return dict(launches.LAUNCHES)


def phase_ssm_layer(dev):
    """Phase 9: one mamba2-780m mixer at full width through the kernel
    (``ssd_fn``), with and without the final state, against the same
    mixer through the plain chunked SSD, on the card."""
    import torch
    from repro_torch import convert, prng
    from repro_torch.kernels import launches
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import apply_ssm, init_ssm, ssd_chunked

    cfg = layer_cfg("mamba2_780m")
    B, S = SSM["B"], SSM["S"]
    g = torch.Generator(device=dev).manual_seed(4)
    lp = convert.layer(init_ssm(cfg, prng.PRNGKey(5), torch.float32,
                                device=dev), 0)
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    tol = SSD_TOL["float32"]
    launches.reset()
    for rs in (False, True):
        what = f"ssm_layer (return_state={rs})"
        walls, out = timed_calls(
            lambda: apply_ssm(cfg, lp, x, return_state=rs, ssd_fn=ssd_scan),
            "ssd_scan", 1, what)
        pwalls, plain = timed_calls(
            lambda: apply_ssm(cfg, lp, x, return_state=rs,
                              ssd_fn=ssd_chunked),
            "ssd_scan", 0, what + " plain SSD")
        outs, plains = (out, plain) if rs else ((out,), (plain,))
        if tuple(outs[0].shape) != (B, S, cfg.d_model) or not all(
                bool(torch.isfinite(t).all()) for t in outs):
            fail(f"ssm_layer (return_state={rs}): wrong shape or not "
                 f"finite")
        errs = [rel_err(a, b) for a, b in zip(outs, plains)]
        if not all(e < tol for e in errs):
            fail(f"ssm_layer (return_state={rs}): off the plain SSD by "
                 f"{errs} of max |ref| (limit {tol})")
        print(f"phase ssm_layer (return_state={rs}): B={B} S={S} "
              f"d_model={cfg.d_model} d_inner={cfg.ssm_d_inner} "
              f"H={cfg.ssm_n_heads} P={cfg.ssm_head_dim} N={cfg.ssm_state} "
              f"chunk={cfg.ssm_chunk} walls_s={walls} "
              f"plain_ssd_walls_s={pwalls} "
              f"rel_errs(out, final, conv)={errs}")
        # the mixer must be faster through the kernel than through the
        # plain SSD (warm calls: the first carries the one-time set-up)
        if not min(walls[1:]) < min(pwalls[1:]):
            fail(f"{what}: warm wall {min(walls[1:])} s through the kernel, "
                 f"{min(pwalls[1:])} s through the plain SSD")
    return dict(launches.LAUNCHES)


def model_layers(cfg, params, tokens, name):
    """``transformer.forward``'s kernel path, layer by layer: each layer's
    attention (or SSD mixer) output through the kernel is held against the
    plain core's on the same input, to phase 8's (9's) limits.  Returns
    the final hidden states and the worst readings: (max abs diff, rel L2
    whole, worst row) for attention, (rel err,) for the mixer."""
    import torch
    from repro_torch.models import attention, ssm, transformer
    from repro_torch.models.common import apply_norm, embed_tokens
    B, S = tokens.shape
    x = embed_tokens(cfg, params, tokens)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(
        B, S)
    worst = []
    for li, window in enumerate(transformer.layer_windows(cfg, S)):
        lp = transformer.layer(params["blocks"], li)
        h = apply_norm(cfg, x, lp["ln1"])
        what = f"model {cfg.arch_id} layer {li} ({x.dtype})"
        if name == "flash_attention":
            out = attention.attend_full(cfg, lp["attn"], h, pos, window)
            ref = attention.attend_full(cfg, lp["attn"], h, pos, window,
                                        core=attention.dense_attention)
            tol = ATTN_TOL[str(x.dtype).split(".")[-1]]
            diff = (out.float() - ref.float()).abs()
            if not bool((diff <= tol + tol * ref.float().abs()).all()):
                fail(f"{what}: attention off the dense core by "
                     f"{float(diff.max())}")
            read = ((float(diff.max()),)
                    + (check_rel_l2(out, ref, what)
                       if x.dtype == torch.bfloat16 else rel_l2(out, ref)))
        else:
            out = ssm.apply_ssm(cfg, lp["ssm"], h)
            ref = ssm.apply_ssm(cfg, lp["ssm"], h, ssd_fn=ssm.ssd_chunked)
            read = (rel_err(out, ref),)
            if not read[0] < SSD_TOL["float32"]:
                fail(f"{what}: mixer off the plain SSD by {read[0]} of max "
                     f"|ref|")
        worst = [max(a, b) for a, b in zip(worst or read, read)]
        x, _ = transformer._layer_body(cfg, x, lp, window, pos)
    return apply_norm(cfg, x, params["final_norm"]), worst


def check_model(out, ref, dt, what):
    """An end-to-end model output against the plain cores' (phase 12's
    limits); returns the readings."""
    import torch
    if not bool(torch.isfinite(out.float()).all()):
        fail(f"{what}: not finite")
    if dt == torch.float32:
        err = rel_err(out, ref)
        if not err <= MODEL_F32_TOL:
            fail(f"{what}: {err} of max |ref| off the plain cores (limit "
                 f"{MODEL_F32_TOL})")
        return dict(rel_err=err)
    whole, row = rel_l2(out, ref)
    if not (whole <= MODEL_BF16_REL_L2 and row <= MODEL_BF16_ROW_REL_L2):
        fail(f"{what}: rel L2 {whole} whole (limit {MODEL_BF16_REL_L2}), "
             f"{row} in the worst row (limit {MODEL_BF16_ROW_REL_L2})")
    return dict(rel_l2=whole, worst_row_rel_l2=row)


def serve_run(cfg, params, name, dev):
    """The serve path, f32: ``prefill_into_cache`` over a make_batch prompt
    (decode steps, plain torch: no kernel), then greedy decode; the
    prompt's last logits against ``forward_prefill`` through the kernel on
    the same tokens."""
    import torch
    from repro_torch.data import make_batch
    from repro_torch.kernels import launches
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models import forward_prefill, init_cache, serve_step
    Bs, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    tokens = torch.as_tensor(make_batch(cfg, Bs, P, seed=0)["tokens"],
                             device=dev)
    cache = init_cache(cfg, Bs, P + G, torch.float32, device=dev)
    before = launches.LAUNCHES[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(cfg, params, cache, tokens,
                                       seq_len=P + G)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    last = logits[:, -1]
    cur = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    gen = []
    t0 = time.perf_counter()
    for i in range(G):
        logits, cache = serve_step(cfg, params, cache, cur, P + i,
                                   seq_len=P + G)
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        gen.append(cur)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if launches.LAUNCHES[name] != before:
        fail(f"serve {cfg.arch_id}: the decode path launched {name}")
    walls, ref = timed_calls(lambda: forward_prefill(cfg, params,
                                                     {"tokens": tokens}),
                             name, cfg.n_layers, f"serve {cfg.arch_id} "
                             f"prefill pass", n=1)
    gen = torch.cat(gen, dim=1)
    V = cfg.vocab_size
    diff = (last[:, :V] - ref[:, :V]).abs()
    if not bool((diff <= DECODE_ATOL + DECODE_RTOL * ref[:, :V].abs()
                 ).all()):
        fail(f"serve {cfg.arch_id}: the decode path's prompt logits are "
             f"{float(diff.max())} off the prefill pass through {name}")
    if not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        fail(f"serve {cfg.arch_id}: generated ids outside the vocabulary")
    print(f"phase model_serve: serve {cfg.arch_id} f32 batch={Bs} "
          f"prompt={P} gen={G} prefill_into_cache_s={prefill_s} "
          f"decode_s={decode_s} decode_tok_per_s={G * Bs / decode_s} "
          f"prefill_pass_s={walls} prompt_logits_max_abs_diff_vs_prefill="
          f"{float(diff.max())} sample={gen[0].tolist()}")


def phase_model_serve(dev):
    """Phase 12: the model API at full width through the kernels
    (``forward_prefill``: gemma2-2b f32 and bf16 through
    ``flash_attention``, mamba2-780m f32 through ``ssd_scan``), against the
    same models through the plain cores on the card, layer by layer and
    end to end; the serve path (decode) against the kernels' prefill;
    then ``python -m repro_torch.launch.serve`` as users start it.
    Returns the launch counts of the run."""
    import torch
    from repro_torch import prng
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import launches
    from repro_torch.models import forward_prefill, init_params, transformer
    from repro_torch.models.attention import dense_attention
    from repro_torch.models.common import padded_vocab
    from repro_torch.models.ssm import ssd_chunked

    plain = {"flash_attention": dict(attn_core=dense_attention),
             "ssd_scan": dict(ssd_fn=ssd_chunked)}
    torch.cuda.empty_cache()
    launches.reset()
    for m in MODEL:
        cfg, name = get_config(m["arch"]), m["kernel"]
        tokens = torch.as_tensor(make_batch(cfg, m["B"], m["S"], seed=0)[
            "tokens"], device=dev)
        for dts in m["dtypes"]:
            dt = getattr(torch, dts)
            what = f"model {m['arch']} ({dts}) B={m['B']} S={m['S']}"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = init_params(cfg, prng.PRNGKey(0), dt, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            with torch.no_grad():
                walls, logits = timed_calls(
                    lambda: forward_prefill(cfg, params, {"tokens": tokens}),
                    name, cfg.n_layers, what)
                pwalls, plogits = timed_calls(
                    lambda: forward_prefill(cfg, params, {"tokens": tokens},
                                            **plain[name]),
                    name, 0, what + " plain cores", n=1)
                hidden, layer_worst = model_layers(cfg, params, tokens, name)
                phidden, _ = transformer.forward(cfg, params, tokens,
                                                 **plain[name])
                # the embedding's storage rows: odd vocabularies padded,
                # the pad logits masked to -1e30 (checked, then cut off)
                V = cfg.vocab_size
                if tuple(logits.shape) != (m["B"], padded_vocab(V)) or \
                        bool((logits[:, V:] != -1e30).any()):
                    fail(f"{what}: logits of shape {tuple(logits.shape)} "
                         f"or pad logits not masked")
                logits, plogits = logits[:, :V], plogits[:, :V]
                lg = check_model(logits, plogits, dt, what + " logits")
                hd = check_model(hidden, phidden, dt, what + " hidden")
                peak = torch.cuda.max_memory_allocated()
                print(f"phase model_serve: {what} layers={cfg.n_layers} "
                      f"d_model={cfg.d_model} vocab={cfg.vocab_size} "
                      f"init_s={init_s} prefill_walls_s={walls} "
                      f"plain_cores_walls_s={pwalls} "
                      f"{name}_launches_per_prefill={cfg.n_layers} "
                      f"logits={lg} hidden={hd} worst_layer={layer_worst} "
                      f"max_abs_logit={float(logits.abs().max())} "
                      f"peak_mem_gb={peak / 2 ** 30}")
                if dt == torch.float32:
                    serve_run(cfg, params, name, dev)
            del params, logits, plogits, hidden, phidden
            torch.cuda.empty_cache()
    counts = dict(launches.LAUNCHES)
    for m in MODEL:
        if not counts[m["kernel"]]:
            fail(f"phase model_serve: {m['kernel']} was not launched")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    for arch in ("mamba2-780m", "gemma2-2b"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                            "--arch", arch], cwd=HERE, env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            fail(f"python -m repro_torch.launch.serve --arch {arch} exited "
                 f"{r.returncode}: {r.stderr[-2000:]}")
        print(f"phase model_serve: python -m repro_torch.launch.serve --arch "
              f"{arch}: exit 0 in {time.perf_counter() - t0} s: "
              + " | ".join(r.stdout.strip().splitlines()))
    return counts


def event_ms(fn, reps: int = 5) -> float:
    """Median device time of one eager call (CUDA events around it, one
    warm-up): for calls of milliseconds at model size, where a CUDA graph
    of several calls would hold several sets of outputs."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


class core_timer:
    """Wrap an attention or SSD core so that CUDA events time each call's
    forward and, through tensor hooks, its backward: the backward starts
    when the gradient of the core's output arrives and ends when the last
    gradient of its inputs is made (autograd runs a core's backward nodes
    together: they were made together).  With remat on, a checkpointed
    layer runs its body again in backward: those calls (set
    ``in_backward`` before the backward starts) are timed apart as
    reruns, and their outputs take no gradient (backward goes through
    the first pass's graph), so each call's backward is counted once.
    ``ms()`` gives (forward, rerun, backward) ms, after a sync."""

    def __init__(self, core):
        self.core, self.fwd, self.rerun, self.bwd = core, [], [], []
        self.in_backward = False

    def __call__(self, *args, **kw):
        import torch

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        e0 = event()
        out = self.core(*args, **kw)
        if self.in_backward:
            self.rerun.append((e0, event()))
            return out
        self.fwd.append((e0, event()))
        y = out[0] if isinstance(out, tuple) else out
        ins = [a for a in args if torch.is_tensor(a) and a.requires_grad]
        if y.requires_grad and ins:
            span = {}
            self.bwd.append(span)
            y.register_hook(lambda g: span.__setitem__("s", event()))
            for a in ins:
                a.register_hook(lambda g: span.__setitem__("e", event()))
        return out

    def ms(self):
        import torch
        torch.cuda.synchronize()
        f = sum(a.elapsed_time(b) for a, b in self.fwd)
        r = sum(a.elapsed_time(b) for a, b in self.rerun)
        done = [sp for sp in self.bwd if "s" in sp and "e" in sp]
        b = sum(sp["s"].elapsed_time(sp["e"]) for sp in done)
        return f, r, b, len(done)


def timed_grad(task, params, batch, attr: str, what: str) -> dict:
    """A gradient pass of ``task`` (``loss_and_grad``'s forward and
    backward, with the task's ``remat``) with its ``attr`` core timed,
    run twice (the first warms the allocator for this ``remat``) and
    read from the second: the pass's ms, its peak memory and the memory
    held before it (GiB), the core's forward, rerun and backward ms and
    calls.  Fails unless each first-pass call has its one backward, and
    the reruns number the calls with remat on and none without."""
    import torch
    from repro_torch import tree
    from repro_torch.models import train_loss
    for _ in range(2):
        timer = core_timer(getattr(task, attr))
        setattr(task, attr, timer)
        try:
            flat = [l.detach().requires_grad_(True)
                    for l in tree.leaves(params)]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            with torch.enable_grad():
                loss = train_loss(task.cfg, tree.unflatten(params, flat),
                                  batch, remat=task.remat,
                                  attn_core=task.attn_core,
                                  ssd_fn=task.ssd_fn)
                timer.in_backward = True
                grads = torch.autograd.grad(loss, flat, allow_unused=True)
            e1.record()
            e1.synchronize()
            peak = torch.cuda.max_memory_allocated()
            f, r, b, nb = timer.ms()
        finally:
            setattr(task, attr, timer.core)
        del loss, grads, flat
    n, nr = len(timer.fwd), len(timer.rerun)
    if nb != n or nr != (n if task.remat else 0):
        fail(f"{what}: {n} first-pass core calls, {nb} backward spans, "
             f"{nr} reruns (remat={task.remat})")
    step = e0.elapsed_time(e1)
    return dict(step_ms=step, peak_gb=peak / 2 ** 30,
                held_before_gb=base / 2 ** 30, fwd_ms=f, rerun_ms=r,
                bwd_ms=b, calls=n, reruns=nr, share=(f + b) / step,
                share_with_reruns=(f + r + b) / step)


def model_train_step(dev):
    """Phase 13 (a): one ``BatchModelTask`` step of gemma2-2b at full
    width with remat (the default), its loss against ``train_loss``
    through the kernels under no grad (phase 12's f32 limit), U against
    the step's own gradient, w against w0 - eta U bit for bit; then the
    same step without remat, its loss and every gradient bit for bit the
    first's; both steps' walls and peak memory, and a warm gradient pass
    of each with the attention cores' share (CUDA events in autograd
    hooks; the first pass's forward and each call's backward, the
    reruns beside them)."""
    import torch
    from repro_torch import prng, tree
    from repro_torch.configs import get_config
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    from repro_torch.models import init_params, train_loss

    ts = TRAIN_STEP
    cfg = get_config(ts["arch"])
    what = f"model_train (a) {ts['arch']} B={ts['B']} S={ts['S']}"
    torch.cuda.empty_cache()
    params = init_params(cfg, prng.PRNGKey(0), torch.float32, device=dev)
    batcher = SeedAddressedBatcher(cfg, batch_size=ts["B"],
                                   seq_len=ts["S"], seed=0, device=dev)
    task = BatchModelTask(cfg, params, batcher)
    inner = task.loss_and_grad
    steps = {}
    for remat in (True, False):
        task.remat = remat
        seen = {}

        def spy(p, b):
            seen["loss"], seen["g"] = inner(p, b)
            return seen["loss"], seen["g"]

        task.loss_and_grad = spy
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, U = task.run_iterations(params, task.zero_update(), round_idx=0,
                                   client_id=0, start_h=0, n_iters=1,
                                   eta=ts["eta"], rng=prng.PRNGKey(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        task.loss_and_grad = inner
        if remat:
            e = float(torch.tensor(ts["eta"], dtype=torch.float32))
            for p, u, g, nw in zip(tree.leaves(params), tree.leaves(U),
                                   seen["g"], tree.leaves(w)):
                if not torch.equal(u, g):
                    fail(f"{what}: U is not the step's gradient")
                if not bits_equal(nw, p - e * g):
                    fail(f"{what}: w is not w0 - eta * U bit for bit")
            gnorm = float(torch.sqrt(sum(torch.sum(g * g)
                                         for g in seen["g"])))
            # the gradient on the host while the other step runs
            ref = (seen["loss"].cpu(), [g.cpu() for g in seen["g"]])
        else:
            same = bits_equal(seen["loss"].cpu(), ref[0]) and all(
                bits_equal(g.cpu(), h) for g, h in zip(seen["g"], ref[1]))
            print(f"phase model_train: {what} remat on and off: loss and "
                  f"{len(ref[1])} gradient leaves bit for bit: {same}")
            if not same:
                fail(f"{what}: the step without remat differs from the "
                     f"step with it")
        steps[remat] = dict(wall=wall, peak=peak, loss=task.last_loss)
        del w, U, seen
    del ref
    task.remat = True
    batch = batcher(0, 0, 0)
    with torch.no_grad():
        kloss = float(train_loss(cfg, params, batch))
    rel = abs(steps[True]["loss"] - kloss) / abs(kloss)
    if not rel <= MODEL_F32_TOL:
        fail(f"{what}: the step's loss {steps[True]['loss']} (plain "
             f"cores) is {rel} off the kernels' {kloss} (> "
             f"{MODEL_F32_TOL})")
    torch.cuda.empty_cache()
    for remat in (True, False):
        task.remat = remat
        steps[remat]["grad"] = timed_grad(task, params, batch, "attn_core",
                                          what)
    on, off = steps[True], steps[False]
    print(f"phase model_train: {what} layers={cfg.n_layers} d_model="
          f"{cfg.d_model} vocab={cfg.vocab_size} loss={on['loss']} "
          f"kernel_route_loss={kloss} rel={rel} grad_norm={gnorm} "
          f"remat_on: step_wall_s={on['wall']} peak_mem_gb="
          f"{on['peak'] / 2 ** 30} grad_pass={on['grad']} remat_off: "
          f"step_wall_s={off['wall']} peak_mem_gb={off['peak'] / 2 ** 30} "
          f"grad_pass={off['grad']} (attn_core share: the first pass's "
          f"forward and each call's backward; reruns apart)")
    del params, task
    torch.cuda.empty_cache()
    return dict(step_wall_s=on["wall"], peak_gb=on["peak"] / 2 ** 30,
                attn_share=on["grad"]["share"],
                step_wall_s_no_remat=off["wall"],
                peak_gb_no_remat=off["peak"] / 2 ** 30,
                attn_share_no_remat=off["grad"]["share"])


def engine_rows(eng) -> dict:
    """The device engine's [*, D] f32 rows: held in its state (counted
    from the state's tensors), and reckoned at most alive at once in a
    completion tick: the state, the tick's new v (the server step resets
    the ring and writes the broadcast rows in place), the SGD block's
    copies of w and U and one gradient, the clipped and noised sent rows
    (with DP only; without, the sent rows are U), tick_scatter's w, U,
    ring rows and block partials."""
    import torch
    C, L, D = eng.C, eng.L, eng.D
    held = sum(t.numel() for t in eng.state
               if torch.is_tensor(t) and t.dim() and t.shape[-1] == D) // D
    sent = C if eng.dp_on else 0
    return dict(held=held,
                peak=held + 1 + 2 * C + 1 + sent + 2 * C + L + L)


def cohort_fits(dev, cfg) -> tuple:
    """Phase 13 (b)'s hungriest run, the device engine with DP and
    operand noise (the clipped, noised sent rows are C more rows), for
    one round at ``cfg``'s depth: (fits, peak bytes, what ran out of
    memory)."""
    import torch
    import repro_torch as rt
    from repro_torch import prng
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    from repro_torch.models import init_params

    tc = TRAIN_COHORT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    why = None
    try:
        params = init_params(cfg, prng.PRNGKey(tc["seed"]), torch.float32,
                             device=dev)
        batcher = SeedAddressedBatcher(cfg, batch_size=tc["B"],
                                       seq_len=tc["S"], seed=tc["seed"],
                                       device=dev)
        sim = rt.DeviceCohortSimulator(
            BatchModelTask(cfg, params, batcher, dp_clip=tc["clip"],
                           dp_sigma=tc["sigma"]),
            latency=tc["latency"], block=tc["block"], dp_rng="operand",
            n_clients=tc["C"],
            sizes_per_client=tc["sizes"], round_stepsizes=tc["etas"],
            d=tc["d"], seed=tc["seed"], speeds=tc["speeds"], device=dev)
        timed_run(sim, 1, 1)
    except torch.cuda.OutOfMemoryError as e:
        why = str(e).splitlines()[0][:300]
    return why is None, torch.cuda.max_memory_allocated(), why


def model_cohort(dev):
    """Phase 13 (b): mamba2-780m on the device engine, the host engine
    and the event simulator (``TRAIN_COHORT``), at its full depth where
    the device engine fits the card, else at ``cut_layers``; returns the
    launches, walls and the kernels' times at model D."""
    import dataclasses
    import gc

    import torch
    import repro_torch as rt
    from repro_torch import prng, tree
    from repro_torch.cohort import PyTreeFlattener
    from repro_torch.configs import get_config
    from repro_torch.core import BatchModelTask
    from repro_torch.data import SeedAddressedBatcher
    from repro_torch.kernels import launches
    from repro_torch.models import init_params

    tc = TRAIN_COHORT
    cfg = get_config(tc["arch"])
    full_layers = cfg.n_layers
    t0 = time.perf_counter()
    fits, full_peak, why = cohort_fits(dev, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase model_train: (b) {tc['arch']} at its {full_layers} layers,"
          f" the device engine with DP (operand noise) for one round: "
          f"fits={fits} "
          f"peak_mem_gb={full_peak / 2 ** 30} card_gb="
          f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30} "
          f"wall_s={time.perf_counter() - t0}"
          + (f" ({why})" if why else ""))
    if not fits:
        cfg = dataclasses.replace(cfg, n_layers=tc["cut_layers"])
    t0 = time.perf_counter()
    params = init_params(cfg, prng.PRNGKey(tc["seed"]), torch.float32,
                         device=dev)
    batcher = SeedAddressedBatcher(cfg, batch_size=tc["B"], seq_len=tc["S"],
                                   seed=tc["seed"], device=dev)
    D = sum(l.numel() for l in tree.leaves(params))
    # D at the config's own depth, for the reckoning of the cut
    D_full = D + (full_layers - cfg.n_layers) * (sum(
        l.numel() for l in tree.leaves(params["blocks"])) // cfg.n_layers)
    print(f"phase model_train: (b) {tc['arch']} layers={cfg.n_layers} of "
          f"{full_layers} d_model={cfg.d_model} D={D} (D at {full_layers} "
          f"layers: {D_full}) row_gb={4 * D / 1e9} init_s="
          f"{time.perf_counter() - t0}")

    def task(dp: bool, remat: bool = True):
        return BatchModelTask(cfg, params, batcher,
                              dp_clip=tc["clip"] if dp else 0.0,
                              dp_sigma=tc["sigma"] if dp else 0.0,
                              remat=remat)

    for remat in (True, False):
        g = timed_grad(task(False, remat), params, batcher(0, 0, 0),
                       "ssd_fn", "phase model_train (b)")
        print(f"phase model_train: (b) one step's gradient, remat="
              f"{remat}: ms={g['step_ms']} peak_mem_gb={g['peak_gb']} "
              f"held_before_gb={g['held_before_gb']} "
              f"ssd_core_fwd_ms={g['fwd_ms']} "
              f"ssd_core_rerun_ms={g['rerun_ms']} ssd_core_bwd_ms="
              f"{g['bwd_ms']} calls={g['calls']} reruns={g['reruns']} "
              f"ssd_core_share={g['share']} (the first pass's forward and "
              f"each call's backward)")
    kw = dict(n_clients=tc["C"], sizes_per_client=tc["sizes"],
              round_stepsizes=tc["etas"], d=tc["d"], seed=tc["seed"],
              speeds=tc["speeds"], device=dev)
    lat = tc["latency"]
    engines = {
        "device": lambda dp, rng, remat: rt.DeviceCohortSimulator(
            task(dp, remat), latency=lat, block=tc["block"], dp_rng=rng,
            **kw),
        "host": lambda dp, rng, remat: rt.CohortSimulator(
            task(dp, remat), latency_fn=lambda r: lat, block=tc["block"],
            **kw),
        "event": lambda dp, rng, remat: rt.AsyncFLSimulator(
            task(dp, remat), latency_fn=lambda r: lat, **kw)}
    out = {"launches": {}, "walls": {}, "D": D, "layers": cfg.n_layers,
           "peaks_gb": {}}
    fps = {}
    for name, dp, rng, remat in (("device", False, "operand", True),
                                 ("device", False, "operand", False),
                                 ("host", False, "operand", True),
                                 ("device", True, "operand", True),
                                 ("host", True, "operand", True),
                                 ("device", True, "in_kernel", True),
                                 ("event", False, "operand", True)):
        tag = f"{name} dp={dp}" + (f" {rng}" if dp and name == "device"
                                   else "") + ("" if remat else " remat=off")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = engines[name](dp, rng, remat)
        launches.reset()
        res, wall = timed_run(sim, tc["rounds"], 1)
        counts = dict(launches.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        rows = engine_rows(sim.engine) if name == "device" else None
        if name != "event":
            # one server-step launch a tick (device) or an apply (host)
            tel = res["telemetry"]
            steps = (tel.ticks if name == "device"
                     else int(tel.ops["bucket_applies"]))
            if counts["bucket_apply"] != steps:
                fail(f"phase model_train (b) {tag}: "
                     f"{counts['bucket_apply']} server-step launches for "
                     f"{steps} {'ticks' if name == 'device' else 'applies'}")
            out.setdefault("server_steps", {})[tag] = steps
        if name == "event":
            tel = res["telemetry"]
            fp = {"ints": {"rounds": tel.rounds, "messages": tel.messages,
                           "broadcasts": tel.broadcasts,
                           "participation": [int(x) for x in
                                             tel.participation],
                           "staleness_hist": [int(x) for x in
                                              tel.staleness_hist]},
                  "losses": [h["loss"] for h in res["history"]]
                  + [res["final"]["loss"]],
                  "v": PyTreeFlattener(params).flatten(res["model"]).cpu()}
        else:
            fp = fingerprint(sim, res)
            fp["blocks"] = {k: v.cpu() for k, v in fp["blocks"].items()}
        print(f"phase model_train: (b) {tag}: rounds={res['final']['round']}"
              f" messages={res['final']['messages']} wall_s={wall} "
              f"peak_mem_gb={peak / 2 ** 30} launches={counts} losses="
              f"{fp['losses']}"
              + (f" rows_held={rows['held']} rows_peak={rows['peak']} "
                 f"reckoned_rows_gb={rows['peak'] * 4 * D / 2 ** 30} "
                 f"at_{full_layers}_layers: reckoned_rows_gb="
                 f"{rows['peak'] * 4 * D_full / 2 ** 30} peak_mem_gb_scaled="
                 f"{peak * D_full / D / 2 ** 30}"
                 if rows else ""))
        out["peaks_gb"][tag] = peak / 2 ** 30
        if not remat:
            # remat changes what backward keeps, not one bit of the run
            same_run(fps["device dp=False"], fp,
                     "phase model_train (b) remat on and off")
            del sim, res, fp
            torch.cuda.empty_cache()
            continue
        # with DP the noise (std clip * sigma = 8 a coordinate) overwhelms
        # the model and its loss may overflow, in the reference as here;
        # those runs are held bit for bit between the engines instead
        if not dp and not all(math.isfinite(x) for x in fp["losses"]):
            fail(f"phase model_train (b) {tag}: a loss is not finite")
        fps[tag] = fp
        out["launches"][tag] = counts
        out["walls"][tag] = wall
        del sim, res
        torch.cuda.empty_cache()
    print(f"phase model_train: (b) server-step launches: one a tick "
          f"(device) or an apply (host): {out['server_steps']}")
    same_run(fps["host dp=False"], fps["device dp=False"],
             "phase model_train (b) without DP")
    same_run(fps["host dp=True"], fps["device dp=True operand"],
             "phase model_train (b) operand noise")
    ik, op = fps["device dp=True in_kernel"], fps["device dp=True operand"]
    if ik["ints"] != op["ints"]:
        fail("phase model_train (b): in-kernel noise changed the protocol")
    if ik["losses"][0] == op["losses"][0]:
        fail("phase model_train (b): the two noise sources gave one model")
    ev, dv = fps["event dp=False"], fps["device dp=False"]
    bad = [k for k, x in ev["ints"].items() if x != dv["ints"][k]]
    if bad:
        fail(f"phase model_train (b): the event simulator's {bad} differ "
             f"from the device engine's")
    loss_d = max(abs(a - b) for a, b in zip(ev["losses"], dv["losses"]))
    model_d = float((ev["v"] - dv["blocks"]["v"]).abs().max())
    print(f"phase model_train: (b) event vs device engine: ints equal, "
          f"max loss diff {loss_d} (limit {EVENT_LOSS_ATOL}), max model "
          f"diff {model_d} (limit {EVENT_MODEL_ATOL})")
    if not (loss_d <= EVENT_LOSS_ATOL and model_d <= EVENT_MODEL_ATOL):
        fail("phase model_train (b): the event simulator is outside its "
             "limits against the cohort engines")
    del fps, params
    torch.cuda.empty_cache()
    out["kernels"] = model_d_kernels(dev, tc["C"], D)
    return out


def model_d_kernels(dev, C: int, D: int) -> dict:
    """Rows 1-5 at model D: each wrapper's output against its plain
    version slab by slab (bitwise, or the phase 1 limits), then the
    median time of one launch and its bound (row 1: the server step,
    beside ``bucket_apply`` alone and the separate-launch route).  Not
    counted as launches of the path (the counts are read before)."""
    import torch
    from repro_torch import prng
    from repro_torch.analysis.salts import NOISE_SALT
    from repro_torch.cohort.state import next_pow2
    from repro_torch.kernels.cohort_dp import (cohort_clip_noise,
                                               cohort_clip_noise_prng)
    from repro_torch.kernels.cohort_dp.ref import (cohort_clip_noise_ref,
                                                   counter_normals)
    from repro_torch.kernels.tick_fused import (bucket_apply,
                                                bucket_apply_ref,
                                                server_apply,
                                                server_apply_ref,
                                                tick_deliver,
                                                tick_deliver_ref,
                                                tick_scatter,
                                                tick_scatter_ref)

    g = torch.Generator(device=dev).manual_seed(1)
    B, L, f4 = next_pow2(TRAIN_COHORT["d"] + 2), 2, 4
    done = torch.tensor([True, False][:C] + [True] * (C - 2), device=dev)
    eta = torch.full((C,), 0.1, device=dev)
    nd = int(done.sum())
    out = {}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def slabs():
        return ((lo, min(lo + MODEL_D_SLAB, D))
                for lo in range(0, D, MODEL_D_SLAB))

    def record(name, ms, bnd, lib=None):
        bms, by = bnd
        out[name] = dict(ms_model_D=ms, bound_model_D_ms=bms,
                         bound_model_D_by=by, library_model_D_ms=lib)
        print(f"phase model_train: {name} at C={C} D={D}: ms={ms} "
              f"bound_ms={bms} ({by})"
              + (f" library_ms={lib}" if lib is not None else ""))

    # bucket_apply, A = 1, flag on
    v, rows = randn(D), randn(1, D)
    dec, fl = torch.ones(1, device=dev), torch.tensor(True, device=dev)
    k = bucket_apply(v, rows, dec, fl)
    for lo, hi in slabs():
        if not bits_equal(k[lo:hi], bucket_apply_ref(v[lo:hi],
                                                     rows[:, lo:hi], dec,
                                                     fl)):
            fail(f"bucket_apply at D={D}: not bitwise at [{lo}, {hi})")
    del k
    lib = event_ms(lambda: torch.addmv(v, rows.T, dec, alpha=-1))
    bare_ms = event_ms(lambda: bucket_apply(v, rows, dec, fl))
    bare_bound, _ = bound(f4 * 3 * D, 2 * D)
    del rows

    # row 1 as the path runs it: the server step of phase (b)'s ticks (the
    # paper's strategy, no far tier), the slot reset in place, and on a
    # cascade tick v' into one fired broadcast row; against its twin slab
    # by slab, then timed with and without the fired row beside the
    # separate-launch route on the same operands
    ring, bc = randn(L, 1, D), randn(B, D)
    fired = torch.zeros(B, dtype=torch.bool, device=dev)
    fired[1] = True
    slot0, bc0 = ring[1].clone(), bc.clone()
    k = server_apply(v, ring[1], dec, fl, reset=True, bc_v=bc, fired=fired)
    zero = torch.zeros(1, device=dev).expand(1, MODEL_D_SLAB)
    for lo, hi in slabs():
        pbc = bc0[:, lo:hi].clone()
        p = server_apply_ref(v[lo:hi], slot0[:, lo:hi].clone(), dec, fl,
                             reset=True, bc_v=pbc, fired=fired)
        if not (bits_equal(k[lo:hi], p) and bits_equal(bc[:, lo:hi], pbc)
                and bits_equal(ring[1][:, lo:hi], zero[:, :hi - lo])):
            fail(f"server_apply at D={D}: not bitwise at [{lo}, {hi})")
    del k, slot0, bc0
    times = {}
    for nf in (0, 1):
        kw = dict(bc_v=bc, fired=fired) if nf else {}
        t_k = event_ms(lambda: server_apply(v, ring[1], dec, fl, reset=True,
                                            **kw))
        t_o = event_ms(lambda: old_server_route(v, ring, 1, dec, fl, **kw))
        times[nf] = (t_k, t_o, server_bound(D, 1, arr=True, fired=nf))
    record("bucket_apply", times[0][0], times[0][2], lib=lib)
    out["bucket_apply"].update(
        old_route_model_D_ms=times[0][1], ms_model_D_cascade=times[1][0],
        bound_model_D_cascade_ms=times[1][2][0],
        old_route_model_D_cascade_ms=times[1][1],
        ms_model_D_bucket_apply=bare_ms,
        bound_model_D_bucket_apply_ms=bare_bound)
    print(f"phase model_train: server_apply at C={C} D={D}: ms={times[0][0]} "
          f"(cascade {times[1][0]}) bound_ms={times[0][2][0]} (cascade "
          f"{times[1][2][0]}) old_route_ms={times[0][1]} (cascade "
          f"{times[1][1]}); bucket_apply alone ms={bare_ms} bound_ms="
          f"{bare_bound}")
    del v, ring, bc

    # tick_deliver: row 0 takes broadcast 1, row 1 keeps w
    w, U, bc_v = randn(C, D), randn(C, D), randn(B, D)
    best = torch.ones(C, dtype=torch.int64, device=dev)
    take = done.clone()
    k = tick_deliver(w, U, bc_v, best, take, eta)
    for lo, hi in slabs():
        p = tick_deliver_ref(w[:, lo:hi], U[:, lo:hi], bc_v[:, lo:hi], best,
                             take, eta)
        if not bits_equal(k[:, lo:hi].contiguous(), p):
            fail(f"tick_deliver at D={D}: not bitwise at [{lo}, {hi})")
    del k
    nt = int(take.sum())
    # taken rows read U and their broadcast row, the others w
    record("tick_deliver",
           event_ms(lambda: tick_deliver(w, U, bc_v, best, take, eta)),
           bound(f4 * (nt * D + (C - nt) * D + D + C * D), 2 * nt * D))
    del bc_v

    # tick_scatter: the done row into ring row 0, ring row 1 unreached
    sent, upd = randn(C, D), randn(L, D)
    wgt = torch.stack([eta * done.float(), torch.zeros_like(eta)])
    any_g = wgt.abs().sum(1) > 0
    kw, ku, kr = tick_scatter(sent, w, U, upd, wgt, any_g, done, eta,
                              dp_on=True)
    for lo, hi in slabs():
        pw, pu, pr = tick_scatter_ref(sent[:, lo:hi], w[:, lo:hi],
                                      U[:, lo:hi], upd[:, lo:hi], wgt,
                                      any_g, done, eta, dp_on=True)
        if not (bits_equal(kw[:, lo:hi].contiguous(), pw)
                and bits_equal(ku[:, lo:hi].contiguous(), pu)):
            fail(f"tick_scatter at D={D}: w / U not bitwise at "
                 f"[{lo}, {hi})")
        tol = SUM_RTOL * (wgt.abs() @ sent[:, lo:hi].abs()) + 1e-30
        if not bool(((kr[:, lo:hi] - pr).abs() <= tol).all()):
            fail(f"tick_scatter at D={D}: ring rows off at [{lo}, {hi})")
    del kw, ku, kr
    record("tick_scatter", event_ms(lambda: tick_scatter(
        sent, w, U, upd, wgt, any_g, done, eta, dp_on=True)),
        scatter_bound(C, D, L, nd))
    del sent, upd, w

    # cohort_clip_noise, operand noise, no round clip (the path's call)
    noise = randn(C, D)
    wts = eta * done.float()
    ns = TRAIN_COHORT["clip"] * TRAIN_COHORT["sigma"]
    k, _ = cohort_clip_noise(U, noise, wts, done, clip=0.0, noise_scale=ns,
                             with_agg=False)
    for lo, hi in slabs():
        p, _ = cohort_clip_noise_ref(U[:, lo:hi], noise[:, lo:hi], wts,
                                     done, clip=0.0, noise_scale=ns,
                                     with_agg=False)
        if not bits_equal(k[:, lo:hi].contiguous(), p):
            fail(f"cohort_clip_noise at D={D}: not bitwise at "
                 f"[{lo}, {hi})")
    del k
    # read u and the masked rows' noise, write out
    record("cohort_clip_noise", event_ms(lambda: cohort_clip_noise(
        U, noise, wts, done, clip=0.0, noise_scale=ns, with_agg=False)),
        bound(f4 * (2 * C * D + nd * D + 2 * C), 2 * nd * D))
    del noise

    # cohort_clip_noise_prng: the counter normals of flat index c * D + d,
    # past 2**31 for the second row
    key = prng.fold_in(prng.PRNGKey(TRAIN_COHORT["seed"] ^ NOISE_SALT), 7)
    k, _ = cohort_clip_noise_prng(U, key, wts, done, clip=0.0,
                                  noise_scale=ns, with_agg=False)
    err = 0.0
    for c in range(C):
        for lo, hi in slabs():
            n = counter_normals(key, 1, hi - lo, device=dev,
                                start=c * D + lo)
            p, _ = cohort_clip_noise_ref(U[c:c + 1, lo:hi], n, wts[c:c + 1],
                                         done[c:c + 1], clip=0.0,
                                         noise_scale=ns, with_agg=False)
            got = k[c:c + 1, lo:hi]
            if not bool(done[c]):
                ok = bits_equal(got.contiguous(), p)
            else:
                ok = bool(((got - p).abs() <= ROW_RTOL * (
                    U[c:c + 1, lo:hi].abs() + ns * n.abs())).all())
            if not ok:
                fail(f"cohort_clip_noise_prng at D={D}: row {c} off at "
                     f"[{lo}, {hi})")
            err = max(err, float((got - p).abs().max()))
    del k
    hashed = nd * D
    record("cohort_clip_noise_prng", event_ms(lambda: cohort_clip_noise_prng(
        U, key, wts, done, clip=0.0, noise_scale=ns, with_agg=False)),
        bound(f4 * (2 * C * D + C), PRNG_F32_OPS * hashed,
              PRNG_INT_OPS * hashed))
    out["cohort_clip_noise_prng"]["max_abs_err_model_D"] = err
    del U
    torch.cuda.empty_cache()
    return out


def model_train_driver(dev):
    """Phase 13 (c): ``python -m repro_torch.launch.train`` as users
    start it, at full width with a checkpoint that must load back
    through ``load_fl_state``, and reduced with DP."""
    import shutil
    import tempfile

    import torch
    from repro_torch import prng, tree
    from repro_torch.checkpoint import load_fl_state
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(HERE, "build"))
    walls = []
    try:
        for i, args in enumerate(TRAIN_DRIVER):
            ck = os.path.join(tmp, f"ck{i}")
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m",
                                "repro_torch.launch.train", *args,
                                "--checkpoint", ck], cwd=HERE, env=env,
                               capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            walls.append(wall)
            if r.returncode:
                fail(f"python -m repro_torch.launch.train {' '.join(args)} "
                     f"exited {r.returncode}: {r.stderr[-2000:]}")
            print(f"phase model_train: (c) python -m repro_torch.launch."
                  f"train {' '.join(args)}: exit 0 in {wall} s: "
                  + " | ".join(r.stdout.strip().splitlines()))
            if i == 0:
                # the full-width run's checkpoint, into a template of the
                # model on the card (another seed: every leaf is replaced)
                tmpl = init_params(get_config(args[1]), prng.PRNGKey(1),
                                   torch.float32, device=dev)
                model, k = load_fl_state(ck, tmpl)
                pairs = list(zip(tree.leaves(model), tree.leaves(tmpl)))
                n = sum(a.numel() for a, _ in pairs)
                ok = (k == 3 and all(
                    a.shape == b.shape and a.dtype == b.dtype
                    and a.device == b.device and bool(torch.isfinite(a).all())
                    for a, b in pairs)
                    and any(not torch.equal(a, b) for a, b in pairs))
                print(f"phase model_train: (c) checkpoint of {args[1]} "
                      f"loads: server_k={k} params={n} ok={ok}")
                if not ok:
                    fail(f"(c) the checkpoint of {args[1]} does not load "
                         f"back as the model")
                del model, tmpl, pairs
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return walls


def phase_model_train(dev):
    """Phase 13: (a), (b) and (c) above; returns the launches of the
    model-scale cohort runs and the kernels' times at model D."""
    t0 = time.perf_counter()
    a = model_train_step(dev)
    print(f"phase model_train: (a) wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    b = model_cohort(dev)
    print(f"phase model_train: (b) wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    c = model_train_driver(dev)
    print(f"phase model_train: (c) wall_s={time.perf_counter() - t0} "
          f"driver_walls_s={c}")
    return a, b

# phase 14: the main run traced (the JSONL ``trace=`` and the engine's
# wall spans), its Perfetto timelines and the trace checks, under the
# profiler, and the cost of tracing
TRACE_DIR = os.path.join(HERE, "build", "trace")
TRACE_COST_REPS = 3


def trace_violations(what: str, records, doc, d: int) -> None:
    """Fail unless one run's records and timeline pass every check: the
    document's schema and tracks, INV-SPAN over it, the INV-* rules of
    the JSONL at ``d`` and the report's own census."""
    from repro_torch.analysis.invariants import (check_perfetto,
                                                 check_report, check_trace)
    from repro_torch.telemetry import validate_trace_events
    reports = [(i, r) for i, r in enumerate(records, 1)
               if r["kind"] == "report"]
    if len(reports) != 1:
        fail(f"phase trace: {what}: {len(reports)} report records")
    checks = (("validate_trace_events", validate_trace_events(doc)),
              ("check_perfetto", check_perfetto(doc)),
              ("check_trace", check_trace(records, d=d)),
              ("check_report", check_report(reports[0][1], d=d,
                                            line=reports[0][0])))
    for name, found in checks:
        if found:
            fail(f"phase trace: {what}: {name} found {len(found)}: "
                 f"{found[:5]}")


def traced_main(dev, X, y, kw, dp_rng: str, path=None, spans=None):
    """One main run (phase 3's configuration), with ``trace=path`` and
    the engine's span recorder ``spans``."""
    m = MAIN
    sim = make_sim(dev, X, y, block=m["block"], dp_rng=dp_rng, trace=path,
                   **kw)
    sim.engine.spans = spans
    res, wall = timed_run(sim, m["rounds"], m["rounds"] // 2)
    if res["final"]["round"] < m["rounds"]:
        fail(f"phase trace: main run ({dp_rng}) reached round "
             f"{res['final']['round']}")
    return sim, res, wall


def plant_regression(records, d: int) -> list:
    """Phase 14 (b): the last segment's ``messages`` and
    ``staleness_hist[0]`` (and its ``overflow_hwm`` where the previous
    mark is above 0) set below the previous segment's; returns the
    rules the checker reports, failing unless INV-MONO (and INV-LATCH
    where planted) are among them."""
    import copy
    from repro_torch.analysis.invariants import check_trace
    recs = copy.deepcopy(records)
    segs = [r for r in recs if r["kind"] == "segment"]
    prev, last = segs[-2], segs[-1]
    last["messages"] = prev["messages"] - 1
    last["staleness_hist"][0] = prev["staleness_hist"][0] - 1
    want = {"INV-MONO"}
    if prev["overflow_hwm"] > 0:
        last["overflow_hwm"] = prev["overflow_hwm"] - 1
        want.add("INV-LATCH")
    rules = sorted({v.rule for v in check_trace(recs, d=d)})
    if not want <= set(rules):
        fail(f"phase trace: (b) the planted regression gave {rules}, "
             f"want {sorted(want)}")
    return rules


def profiled_main(dev, X, y, kw):
    """Phase 14 (e): one main run (operand noise) with the engine's tick
    spans recorded and annotated (``engine.spans =
    SpanRecorder(annotate=True)``) under ``torch.profiler`` with CPU and
    CUDA activities; every span name must be among the profiler's
    events.  Returns the spans, the CUDA time the profiler
    puts inside each span name, the device events' time (kernels and
    copies apart from the spans' own device ranges) and the keys with
    the most self CUDA time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import SpanRecorder

    rec = SpanRecorder(annotate=True, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim, res, wall = traced_main(dev, X, y, kw, "operand", spans=rec)
        torch.cuda.synchronize(dev)
    spans = rec.counts
    names = {e.name for e in prof.events()}
    missing = sorted(set(spans) - names)
    if missing:
        fail(f"phase trace: (e) spans {missing} are not among the "
             f"profiler's events")
    avg = prof.key_averages()

    def device_us(e, attr):
        return getattr(e, attr, getattr(e, attr.replace("device",
                                                        "cuda"), 0))

    inside = {e.key: device_us(e, "device_time_total") / 1e3
              for e in avg if e.key in spans}
    # the device events themselves: kernels and copies, and the spans'
    # own ranges on the device timeline (annotations), apart
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(e.time_range.elapsed_us() for e in on_dev
                  if e.name not in spans) / 1e3
    annotations = sum(e.time_range.elapsed_us() for e in on_dev
                      if e.name in spans) / 1e3
    top = sorted(avg, key=lambda e: -device_us(e, "self_device_time_total"))
    top = {e.key[:40]: device_us(e, "self_device_time_total") / 1e3
           for e in top[:6]}
    return dict(spans=dict(spans), span_cuda_ms=inside,
                kernels_ms=kernels, annotations_ms=annotations,
                top_self_cuda_ms=top, wall_s=wall, report=res["telemetry"])


def phase_trace(dev, X, y, kw, smi: str) -> dict:
    """Phase 14: (a) the main run traced once per noise source, each
    run's JSONL and wall spans made one Perfetto document by the CLI's
    own ``timeline``, every check clean (rows 1-5 launched: counts
    zeroed before, read after); (b) a planted regression the checker
    must catch; (c) the event simulator at C 64 traced, clean at its d;
    (d) ``python -m repro_torch.telemetry capture | convert`` and
    ``python -m repro_torch.analysis src/repro_torch`` as users start
    them; (e) the annotated spans under ``torch.profiler``; (f) the main
    run's wall with and without ``trace=``.  Returns (a)'s launches."""
    import gc
    import io
    import json
    import repro_torch as rt
    from repro_torch.analysis.invariants import check_trace, read_trace
    from repro_torch.kernels import launches
    from repro_torch.telemetry import (JsonlTraceWriter,
                                       validate_trace_events, write_perfetto)
    from repro_torch.telemetry.__main__ import timeline

    m = MAIN
    d = m["d_gate"]
    os.makedirs(TRACE_DIR, exist_ok=True)
    # (a)
    runs = {}
    launches.reset()
    for dp_rng in ("operand", "in_kernel"):
        path = os.path.join(TRACE_DIR, f"main_{dp_rng}.jsonl")
        sim, res, wall = traced_main(dev, X, y, kw, dp_rng, path)
        records = read_trace(path)
        doc = timeline(records, sim.engine.timer)
        write_perfetto(os.path.join(TRACE_DIR, f"main_{dp_rng}.json"), doc)
        trace_violations(f"main ({dp_rng})", records, doc, d)
        segs = [r for r in records if r["kind"] == "segment"]
        if len(segs) != m["rounds"] // (m["rounds"] // 2):
            fail(f"phase trace: main ({dp_rng}) wrote {len(segs)} "
                 f"segments")
        runs[dp_rng] = records
        print(f"phase trace: (a) main ({dp_rng}) C={m['C']} D={m['d'] + 1} "
              f"rounds={m['rounds']} records={len(records)} "
              f"segments={len(segs)} events={len(doc['traceEvents'])} "
              f"wall_spans={len(sim.engine.timer.spans)} violations=0 "
              f"messages={res['telemetry'].messages} wall_s={wall}")
    counts = dict(launches.LAUNCHES)
    for name in TRAIN_PATH:
        if counts[name] <= 0:
            fail(f"phase trace: {name} was not launched on the traced "
                 f"main runs")
    print(f"phase trace: (a) launches={counts}")
    # (b)
    for dp_rng, records in runs.items():
        print(f"phase trace: (b) planted regression in main ({dp_rng}): "
              f"caught {plant_regression(records, d)}")
    # (c)
    e = EVENT
    task, ekw = event_setup(X, y)
    path = os.path.join(TRACE_DIR, "event.jsonl")
    sim = rt.AsyncFLSimulator(task, **ekw, trace=path, device=dev)
    res, wall = timed_run(sim, e["rounds"], 1)
    records = read_trace(path)
    kinds = {}
    for r in records:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    if kinds.get("update_applied", 0) < e["C"] * e["rounds"]:
        fail(f"phase trace: (c) event trace records {kinds}")
    doc = timeline(records, sim.timer)
    trace_violations("event", records, doc, ekw["d"])
    print(f"phase trace: (c) event C={e['C']} d={ekw['d']} "
          f"rounds={e['rounds']} records={len(records)} kinds={kinds} "
          f"events={len(doc['traceEvents'])} violations=0 wall_s={wall}")
    # (d)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out, jl, conv = (os.path.join(TRACE_DIR, f) for f in
                     ("cli.json", "cli.jsonl", "cli_converted.json"))
    for what, args in (
            ("telemetry capture", ["repro_torch.telemetry", "capture",
                                   "--out", out, "--engine", "device",
                                   "--scenario", "mobile_diurnal", "--dp",
                                   "--jsonl-out", jl]),
            ("telemetry convert", ["repro_torch.telemetry", "convert", jl,
                                   "--out", conv]),
            ("analysis", ["repro_torch.analysis",
                          os.path.join("src", "repro_torch")])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m"] + args, cwd=HERE,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        if r.returncode:
            fail(f"phase trace: python -m {' '.join(args)} exited "
                 f"{r.returncode}: {r.stdout[-1000:]} {r.stderr[-2000:]}")
        print(f"phase trace: (d) python -m repro_torch.{what}: exit 0 in "
              f"{time.perf_counter() - t0} s: "
              + " | ".join(r.stdout.strip().splitlines()[-2:]))
    for p in (out, conv):
        with open(p) as fh:
            doc = json.load(fh)
        found = validate_trace_events(doc)
        if found or not doc["traceEvents"]:
            fail(f"phase trace: (d) {p}: {found[:5]}")
    found = check_trace(read_trace(jl), d=2)       # capture's default d
    if found:
        fail(f"phase trace: (d) the captured trace: {found[:5]}")
    # the CLI's exit 0 above covers every family; PURITY-* on its own
    from repro_torch.analysis import purity
    from repro_torch.analysis.base import iter_py_files
    found = purity.check_files(iter_py_files(
        [os.path.join(HERE, "src", "repro_torch")]))
    print(f"phase trace: (d) PURITY-* over src/repro_torch: "
          f"{len(found)} findings")
    if found:
        fail(f"phase trace: (d) PURITY-*: {[v.format() for v in found]}")
    # (e)
    prof = profiled_main(dev, X, y, kw)
    shown = (f"span_cuda_ms={prof['span_cuda_ms']}"
             if any(prof["span_cuda_ms"].values())
             else "the profiler attributes no CUDA time to the spans")
    rep = prof["report"]
    print(f"phase trace: (e) spans={prof['spans']} all among the "
          f"profiler's events; {shown}; device events: kernels and "
          f"copies ms={prof['kernels_ms']}, span ranges ms="
          f"{prof['annotations_ms']}; top self CUDA ms="
          f"{prof['top_self_cuda_ms']}; wall_s={prof['wall_s']}")
    # (f), after collecting (e)'s profiler events: a collection during a
    # timed run would land on whichever run allocates most
    del prof["report"]
    gc.collect()
    traced_main(dev, X, y, kw, "operand")                     # warm-up
    walls = {"off": [], "on": []}
    for _ in range(TRACE_COST_REPS):
        for mode in ("off", "on"):
            path = (os.path.join(TRACE_DIR, "cost.jsonl") if mode == "on"
                    else None)
            walls[mode].append(traced_main(dev, X, y, kw, "operand",
                                           path)[2])
    med = {k: statistics.median(v) for k, v in walls.items()}
    # the report record alone: its emit is host work on a row per client
    emits = []
    for _ in range(TRACE_COST_REPS):
        t0 = time.perf_counter()
        JsonlTraceWriter(io.StringIO()).emit("report", **rep.to_dict())
        emits.append(time.perf_counter() - t0)
    print(f"phase trace: (f) {smi}: main run (operand) wall_s without "
          f"trace={walls['off']} median={med['off']}; with trace="
          f"{walls['on']} median={med['on']}; tracing costs "
          f"{med['on'] - med['off']} s "
          f"({100 * (med['on'] / med['off'] - 1)}%); the report record's "
          f"emit ({len(rep.dp or [])} DP rows) "
          f"s={emits} median={statistics.median(emits)}")
    return counts


# phase 15, the dry run: the CLI as users start it (both archs over the
# four shapes on both fake production meshes, in four processes), then
# the dry run's accounting held against the card on a one-rank mesh at
# full width and a cut depth (2 layers: one local/global period), each
# case's step run for real through the kernels' custom ops
DRYRUN_ARCHS = ("gemma2-2b", "mamba2-780m")
DRYRUN_LAYERS = 2
DRYRUN_CHECK = (dict(arch="gemma2-2b", kind="prefill", B=1, S=32768),
                dict(arch="gemma2-2b", kind="train", B=1, S=4096),
                dict(arch="gemma2-2b", kind="decode", B=4, S=32768),
                dict(arch="mamba2-780m", kind="prefill", B=1, S=32768),
                dict(arch="mamba2-780m", kind="train", B=1, S=4096))
# the predicted live-storage peak against max_memory_allocated above the
# arguments, and the floor of the measured wall under the roofline bound
DRYRUN_PEAK_RTOL = 0.25
# gemma2-2b train_4k on 16x16, temp a card, when the port kept every
# layer's activations (the dry run with --device cpu under torch 2.13)
DRYRUN_TEMP_NO_REMAT_GB = 1140.19
DRYRUN_WALL_FLOOR = 0.95
DRYRUN_DIR = os.path.join(HERE, "build", "dryrun")
# CLI processes at once in (a): the card's machine has 8 cores
DRYRUN_PROCS = 8
# every field of the reference's result rows (repro/launch/dryrun.py,
# roofline.RooflineReport.to_dict)
DRYRUN_FIELDS = {
    "": ("arch", "shape", "mesh", "status", "roofline", "memory_analysis"),
    "roofline": ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
                 "coll_bytes", "coll_breakdown", "model_flops_total",
                 "bytes_per_device", "compile_seconds", "compute_s",
                 "memory_s", "collective_s", "dominant", "useful_ratio"),
    "memory_analysis": ("temp_size_in_bytes", "argument_size_in_bytes",
                        "output_size_in_bytes",
                        "generated_code_size_in_bytes")}


def dryrun_cli(env) -> list:
    """(a): ``python -m repro_torch.launch.dryrun`` for each arch, input
    shape and production mesh (16 processes, ``DRYRUN_PROCS`` at once),
    then ``python -m repro_torch.launch.report`` over their rows;
    returns the rows."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.inputs import shape_is_applicable
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    todo = []
    for arch in DRYRUN_ARCHS:
        for shape in INPUT_SHAPES:
            for mp in (False, True):
                out = os.path.join(DRYRUN_DIR, f"{arch}_{shape}"
                                   f"{'_mp' if mp else ''}.json")
                if os.path.exists(out):
                    os.remove(out)
                todo.append((["--arch", arch, "--shape", shape, "--out",
                              out] + (["--multi-pod"] if mp else []), out))
    # the train steps first: they take longest
    todo.sort(key=lambda t: "train_4k" not in t[0])
    t0 = time.perf_counter()
    running, done = [], []
    while todo or running:
        while todo and len(running) < DRYRUN_PROCS:
            args, out = todo.pop(0)
            log = open(out + ".log", "w")
            running.append((args, out, log, time.perf_counter(),
                            subprocess.Popen(
                                [sys.executable, "-m",
                                 "repro_torch.launch.dryrun"] + args,
                                cwd=HERE, env=env, stdout=log,
                                stderr=subprocess.STDOUT)))
        time.sleep(0.2)
        for job in list(running):
            args, out, log, start, proc = job
            if proc.poll() is None:
                if time.perf_counter() - start > 600:
                    for *_, p in running:
                        p.kill()
                    fail(f"phase dryrun: dryrun {' '.join(args)} ran "
                         f"past 600 s")
                continue
            running.remove(job)
            log.close()
            with open(out + ".log") as f:
                text = f.read()
            print("\n".join(line for line in text.splitlines()
                            if not line.startswith("[")))
            if proc.returncode != 0:
                print(text[-4000:], file=sys.stderr)
                fail(f"phase dryrun: dryrun {' '.join(args)} exited "
                     f"{proc.returncode}")
            done.append(out)
    rows = []
    for out in done:
        with open(out) as f:
            rows += json.load(f)
    print(f"phase dryrun: cli wall_s={time.perf_counter() - t0} "
          f"({len(done)} processes, {DRYRUN_PROCS} at once)")
    for r in rows:
        cfg = get_config(r["arch"])
        ok, _ = shape_is_applicable(cfg, r["shape"])
        if r["status"] == "FAIL":
            fail(f"phase dryrun: FAIL row {r['arch']} {r['shape']} "
                 f"{r['mesh']}: {r.get('error', '')[:400]}")
        if (r["status"] == "SKIP") != (not ok):
            fail(f"phase dryrun: {r['arch']} {r['shape']} {r['mesh']} is "
                 f"{r['status']}, applicable={ok}")
        if r["status"] != "OK":
            continue
        for sect, keys in DRYRUN_FIELDS.items():
            have = r if not sect else r[sect]
            missing = [k for k in keys if k not in have]
            if missing:
                fail(f"phase dryrun: {r['arch']} {r['shape']} {r['mesh']} "
                     f"lacks {sect or 'row'} fields {missing}")
        rf, ma = r["roofline"], r["memory_analysis"]
        cc = r.get("corrected_costs")
        print(f"phase dryrun: {r['arch']} {r['shape']} {r['mesh']} "
              f"flops={rf['hlo_flops']} bytes={rf['hlo_bytes']} "
              f"coll_bytes={rf['coll_bytes']} compute_s={rf['compute_s']} "
              f"memory_s={rf['memory_s']} collective_s={rf['collective_s']} "
              f"dominant={rf['dominant']} useful={rf['useful_ratio']} "
              f"args_bytes={ma['argument_size_in_bytes']} "
              f"temp_bytes={ma['temp_size_in_bytes']} "
              f"trace_s={rf['compile_seconds']} corrected_costs={cc} "
              f"fallbacks={r.get('fallbacks')}")
        if cc is not None and not cc["equal"]:
            fail(f"phase dryrun: {r['arch']} {r['shape']}: corrected_costs "
                 f"differ from the full-depth count: {cc}")
    want = {(a, s) for a in DRYRUN_ARCHS for s in INPUT_SHAPES}
    for mesh in ("16x16", "2x16x16"):
        got = {(r["arch"], r["shape"]) for r in rows if r["mesh"] == mesh}
        if got != want:
            fail(f"phase dryrun: {mesh} rows {sorted(got)}, want "
                 f"{sorted(want)}")
    merged = os.path.join(DRYRUN_DIR, "dryrun_torch.json")
    with open(merged, "w") as f:
        json.dump(rows, f, indent=1)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                        merged], cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0 or "H100 constants" not in r.stdout:
        print(r.stderr[-4000:], file=sys.stderr)
        fail(f"phase dryrun: report exited {r.returncode}")
    print(r.stdout.rstrip())
    return rows


def dryrun_case(case):
    """(cfg, RunConfig, ShapeConfig) of one (b) case: full width,
    ``DRYRUN_LAYERS`` deep."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.launch.dryrun import analysis_variant
    cfg = analysis_variant(get_config(case["arch"]), DRYRUN_LAYERS)
    shape = ShapeConfig(f"{case['kind']}_{case['S']}", case["S"], case["B"],
                        case["kind"])
    return cfg, RunConfig(model=cfg, shape=shape.name), shape


def dryrun_real(case) -> dict:
    """One (b) case run for real on a one-rank NCCL mesh: its argument
    bytes, flops (``FlopCounterMode``), collectives (``CommDebugMode``),
    peak above the arguments and median wall."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch.mesh import make_host_mesh
    cfg, run_cfg, shape = dryrun_case(case)
    mesh = make_host_mesh()
    step, args = dryrun.build_step(cfg, run_cfg, shape, mesh)
    dryrun.fill_inputs(args, cfg.vocab_size, seed=0)
    arg_bytes = inputs.local_bytes(list(args))

    def run():
        with dryrun.placed():
            return step(*args)
    out = run()                       # warm-up: library handles, kernels
    torch.cuda.synchronize()
    del out
    with FlopCounterMode(display=False) as fc, CommDebugMode() as cm:
        out = run()
    torch.cuda.synchronize()
    del out
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del out
    del args
    return dict(arg_bytes=arg_bytes, flops=fc.get_total_flops(),
                comms=cm.get_total_counts(), peak=peak,
                wall=statistics.median(walls), walls=walls)


def dryrun_against_card(smi: str) -> dict:
    """(b): each case's dry run on a fake one-rank mesh against the same
    step on the card; returns the launches of the real runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import launches
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_fake_mesh
    dry = []
    for case in DRYRUN_CHECK:
        cfg, run_cfg, shape = dryrun_case(case)
        mesh = make_fake_mesh((1, 1), ("data", "model"))
        dry.append(dryrun.count_step(cfg, run_cfg, shape, mesh))
    dist.destroy_process_group()
    launches.reset()
    real = [dryrun_real(case) for case in DRYRUN_CHECK]
    counts = dict(launches.LAUNCHES)
    dist.destroy_process_group()
    for case, d, r in zip(DRYRUN_CHECK, dry, real):
        tag = f"{case['arch']} {case['kind']} B={case['B']} S={case['S']}"
        compute_s = d.flops / roofline.PEAK_FLOPS
        memory_s = d.bytes / roofline.HBM_BW
        bound_s = max(compute_s, memory_s)
        rows = (("card", smi), ("layers", DRYRUN_LAYERS),
                ("argument_bytes_dry", d.argument_bytes),
                ("argument_bytes_card", r["arg_bytes"]),
                ("flops_dry", d.flops), ("flops_card", r["flops"]),
                ("collective_bytes_dry", sum(d.coll.values())),
                ("collectives_card", r["comms"]),
                ("peak_bytes_dry", d.temp_bytes),
                ("peak_bytes_card", r["peak"]),
                ("peak_ratio", d.temp_bytes / max(r["peak"], 1)),
                ("bytes_dry", d.bytes), ("compute_s", compute_s),
                ("memory_s", memory_s), ("wall_s", r["wall"]),
                ("walls_s", r["walls"]), ("wall_over_bound",
                                          r["wall"] / bound_s))
        for k, v in rows:
            print(f"phase dryrun: {tag} {k}={v}")
        if d.argument_bytes != r["arg_bytes"]:
            fail(f"phase dryrun: {tag}: argument bytes differ")
        if d.flops != r["flops"]:
            fail(f"phase dryrun: {tag}: flops differ")
        if sum(d.coll.values()) != 0 or r["comms"] != 0:
            fail(f"phase dryrun: {tag}: collectives on one rank")
        if abs(d.temp_bytes - r["peak"]) > DRYRUN_PEAK_RTOL * r["peak"]:
            fail(f"phase dryrun: {tag}: predicted peak {d.temp_bytes} not "
                 f"within {DRYRUN_PEAK_RTOL} of {r['peak']}")
        if r["wall"] < DRYRUN_WALL_FLOOR * bound_s:
            fail(f"phase dryrun: {tag}: wall {r['wall']} s under the "
                 f"roofline bound {bound_s} s: the counts are wrong")
    return counts


def dryrun_ops(dev) -> list:
    """(c): the kernels through their custom ops bit for bit the direct
    launcher calls at phase 12's shapes, the fake implementations'
    shape, dtype and stride the real outputs'; timed for the kernels
    line (op, plain version, library call, bound)."""
    import torch
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_chunked
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    g = torch.Generator(device=dev).manual_seed(15)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    def same_meta(fake, real, what):
        if (tuple(fake.shape), fake.dtype, fake.stride()) != \
                (tuple(real.shape), real.dtype, real.stride()):
            fail(f"phase dryrun: {what}: fake output {tuple(fake.shape)} "
                 f"{fake.dtype} {fake.stride()} is not the real one's "
                 f"{tuple(real.shape)} {real.dtype} {real.stride()}")

    out = []
    gc = get_config("gemma2-2b")
    B, S = MODEL[0]["B"], MODEL[0]["S"]
    H, KV, hd = gc.n_heads, gc.n_kv_heads, gc.head_dim
    cap, W = gc.attn_softcap, gc.sliding_window
    op = torch.ops.repro_torch.flash_attention
    entry = None
    for dt in (torch.float32, torch.bfloat16):
        q = randn(B, S, H, hd).to(dt)
        k, v = randn(B, S, KV, hd).to(dt), randn(B, S, KV, hd).to(dt)
        for window in (None, W):
            o_op = op(q, k, v, True, window, cap)
            o_k = flash_attention_kernel(q, k, v, causal=True,
                                         window=window, softcap=cap)
            if not bits_equal(o_op, o_k):
                fail(f"phase dryrun: flash_attention op {dt} window="
                     f"{window} is not bitwise the launcher's output")
            with FakeTensorMode() as fm:
                fo = op(fm.from_tensor(q), fm.from_tensor(k),
                        fm.from_tensor(v), True, window, cap)
            same_meta(fo, o_op, f"flash_attention {dt} window={window}")
            print(f"phase dryrun: flash_attention op {dt} window={window} "
                  f"bitwise the launcher; fake meta equal")
        if dt == torch.float32:
            kw = dict(causal=True, window=None, softcap=cap)
            ms = median_ms(lambda: op(q, k, v, True, None, cap))
            pms = median_ms(lambda: attention_ref(q, k, v, **kw), n=3,
                            reps=3)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lms = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            fl = attn_flops(B, S, H, hd, None)
            nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 4
            bms, by = bound(nbytes, fl)
            err = float((op(q, k, v, True, None, cap).float()
                         - attention_ref(q, k, v, **kw).float()).abs().max())
            entry = dict(name="flash_attention", route="cuda",
                         source="src/repro_torch/csrc/flash_attention.cu",
                         replaces="src/repro/kernels/flash_attention/"
                                  "kernel.py:92",
                         max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                         bound_by=by, library_ms=lms,
                         via="torch.ops.repro_torch.flash_attention",
                         shape=f"B={B} S={S} H={H} KV={KV} hd={hd} f32 "
                               f"global softcap={cap}")
        del q, k, v
    out.append(entry)

    mc = get_config("mamba2-780m")
    b, s = MODEL[1]["B"], MODEL[1]["S"]
    h, p, n, Q = mc.ssm_n_heads, mc.ssm_head_dim, mc.ssm_state, mc.ssm_chunk
    x, dts = randn(b, s, h, p), F.softplus(randn(b, s, h))
    A = -torch.exp(0.1 * randn(h))
    Bm, Cm = randn(b, s, n), randn(b, s, n)
    sop = torch.ops.repro_torch.ssd_scan
    y_op, f_op = sop(x, dts, A, Bm, Cm, Q, None)
    y_k, f_k = ssd_scan_kernel(x, dts, A, Bm, Cm, Q)
    if not (bits_equal(y_op, y_k) and bits_equal(f_op, f_k)):
        fail("phase dryrun: ssd_scan op is not bitwise the launcher's "
             "output")
    with FakeTensorMode() as fm:
        fy, ff = sop(*(fm.from_tensor(t) for t in (x, dts, A, Bm, Cm)), Q,
                     None)
    same_meta(fy, y_op, "ssd_scan y")
    same_meta(ff, f_op, "ssd_scan final state")
    print("phase dryrun: ssd_scan op bitwise the launcher; fake meta equal")
    ms = median_ms(lambda: sop(x, dts, A, Bm, Cm, Q, None))
    pms = median_ms(lambda: ssd_chunked(x, dts, A, Bm, Cm, Q), n=3, reps=3)
    yr, fr = ssd_chunked(x, dts, A, Bm, Cm, Q)
    err = max(float((y_op - yr).abs().max()), float((f_op - fr).abs().max()))
    nbytes = (2 * b * s * h * p * 4 + 4 * b * s * h + 4 * h
              + 2 * b * s * n * 4 + 4 * b * h * n * p)
    bms, by = bound(nbytes, ssd_flops(b, s, h, p, n, Q))
    out.append(dict(name="ssd_scan", route="cuda",
                    source="src/repro_torch/csrc/ssd_scan.cu",
                    replaces="src/repro/kernels/ssd_scan/kernel.py:68",
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                    bound_by=by, library_ms=None,
                    via="torch.ops.repro_torch.ssd_scan",
                    shape=f"b={b} s={s} h={h} p={p} n={n} chunk={Q} f32"))
    return out


def dryrun_structure(dev) -> None:
    """(d): STRUCT-* on a real device state on the card (no findings),
    and the coverage rule on a spec table with a field dropped
    (STRUCT-PSPEC) and with a dead field added (STRUCT-STALE)."""
    from repro_torch.analysis import structure
    from repro_torch.cohort.state import DeviceCohortState
    from repro_torch.sharding import MeshShape, cohort_pspecs
    found = structure.check_cohort_structure(dev)
    print(f"phase dryrun: STRUCT-* on the card: {len(found)} findings")
    if found:
        fail(f"phase dryrun: STRUCT findings on the card: "
             f"{[v.format() for v in found]}")
    specs = cohort_pspecs(MeshShape(("clients",), (8,)), 16384)
    fields = DeviceCohortState._fields
    dropped = {f: s for f, s in specs.items() if f != "bc_at"}
    dead = dict(specs, w_old=specs["w"])
    rules = ([v.rule for v in structure.check_state_coverage(fields,
                                                             dropped)],
             [v.rule for v in structure.check_state_coverage(fields, dead)])
    print(f"phase dryrun: planted spec faults: field dropped -> {rules[0]}, "
          f"dead field -> {rules[1]}")
    if rules != (["STRUCT-PSPEC"], ["STRUCT-STALE"]):
        fail(f"phase dryrun: planted spec faults read {rules}")


def phase_dryrun(dev, smi: str):
    """Phase 15: (a) the dry-run CLI and report as users start them, (b)
    the dry run's accounting against the card, (c) the kernels' custom
    ops against the launchers, (d) STRUCT-* on the card.  Returns (the
    real runs' launches, the kernels line's rows)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    cli_rows = dryrun_cli(env)
    print(f"phase dryrun: (a) wall_s={time.perf_counter() - t0}")
    # the training steps' plan with remat (RunConfig's default) beside the
    # plan before the port checkpointed its layers
    for r in cli_rows:
        if r["arch"] == "gemma2-2b" and r["shape"] == "train_4k" \
                and r["status"] == "OK":
            print(f"phase dryrun: (a) gemma2-2b train_4k {r['mesh']} with "
                  f"remat: temp_gb="
                  f"{r['memory_analysis']['temp_size_in_bytes'] / 1e9} "
                  f"flops={r['roofline']['hlo_flops']} (16x16 without "
                  f"remat, before it was ported: {DRYRUN_TEMP_NO_REMAT_GB} "
                  f"GB; torch 2.13 on a CPU, --device cpu)")
    t0 = time.perf_counter()
    counts = dryrun_against_card(smi)
    print(f"phase dryrun: (b) wall_s={time.perf_counter() - t0} "
          f"launches={counts}")
    for name in ("flash_attention", "ssd_scan"):
        if not counts.get(name):
            fail(f"phase dryrun: {name} was not launched by the real runs")
    t0 = time.perf_counter()
    rows = dryrun_ops(dev)
    for r in rows:
        r["launches"] = counts[r["name"]]
    print(f"phase dryrun: (c) wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    dryrun_structure(dev)
    print(f"phase dryrun: (d) wall_s={time.perf_counter() - t0}")
    return counts, rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch import _build
    from repro_torch.cohort import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase build: {sorted(logs)} built in "
          f"{time.perf_counter() - t0} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log}", file=sys.stderr)
    dev = resolve_device(None)

    t0 = time.perf_counter()
    X, y, kw = main_inputs()
    server_ops = phase_server_step(dev, X, y, kw)
    print(f"phase server_step: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    kernels = phase_kernels(dev, logs)
    print(f"phase kernels: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_census(dev)
    print(f"phase census: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    counts, main_fps, blocks = phase_main(dev, X, y, kw)
    print(f"phase main: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    kernels.append(phase_client_block(dev, blocks))
    del blocks
    print(f"phase client_block: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    scn_counts, scn_fps = phase_scenarios(dev, X, y, kw)
    print(f"phase scenarios: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_small_scenario(dev)
    print(f"phase small_scenario_agreement: wall_s="
          f"{time.perf_counter() - t0}")
    t0 = time.perf_counter()
    host_counts = phase_host_engine(dev, X, y, kw, main_fps["operand"],
                                    scn_fps)
    del scn_fps
    print(f"phase host_engine: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_cohort_mesh(dev, X, y, kw, main_fps)
    del main_fps
    print(f"phase cohort_mesh: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    phase_event(dev, X, y)
    print(f"phase event: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    G, dp_counts, dp_split = phase_dp_round(dev, X, y)
    print(f"phase dp_round: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    attn_counts = phase_attention_layer(dev)
    print(f"phase attention_layer: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    ssm_counts = phase_ssm_layer(dev)
    print(f"phase ssm_layer: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    kernels += phase_model_kernels(dev, G, logs)
    print(f"phase model_kernels: wall_s={time.perf_counter() - t0}")
    del G
    t0 = time.perf_counter()
    model_counts = phase_model_serve(dev)
    print(f"phase model_serve: wall_s={time.perf_counter() - t0} "
          f"launches={model_counts}")
    t0 = time.perf_counter()
    train_step, train = phase_model_train(dev)
    # the model-scale runs' launches: the device engine's three runs, the
    # host engine's two beside them; each of rows 1-5 at least once
    train_counts = {"device": {}, "host": {}}
    for tag, cnt in train["launches"].items():
        side = tag.split()[0]
        if side in train_counts:
            for name, n in cnt.items():
                train_counts[side][name] = train_counts[side].get(name,
                                                                  0) + n
    for name in TRAIN_PATH:
        if not train_counts["device"].get(name):
            fail(f"phase model_train: {name} was not launched at model D")
    print(f"phase model_train: wall_s={time.perf_counter() - t0} "
          f"launches={train_counts} step={train_step}")
    t0 = time.perf_counter()
    trace_counts = phase_trace(dev, X, y, kw, smi)
    print(f"phase trace: wall_s={time.perf_counter() - t0}")
    t0 = time.perf_counter()
    _, dryrun_rows = phase_dryrun(dev, smi)
    print(f"phase dryrun: wall_s={time.perf_counter() - t0}")
    print(json.dumps({"phase": "dryrun", "kernels": dryrun_rows}))
    # launches: each kernel's count from the path that runs it most: the
    # scenario runs (in-kernel noise) for the tick kernels, each on every
    # tick or completion tick there (the main run's count and the host
    # engine's beside them),
    # the main run for the operand noise kernel, the DP round (split by
    # N), the model API (phase 12) for attention and the SSD (the one-layer
    # phases' counts beside them)
    path_counts = dict(bucket_apply=scn_counts, tick_deliver=scn_counts,
                       tick_scatter=scn_counts, tick_scatter_rows=scn_counts,
                       tick_scatter_finish=scn_counts,
                       cohort_clip_noise_prng=scn_counts,
                       clip_accumulate=dp_counts,
                       flash_attention=model_counts, ssd_scan=model_counts)
    layer_counts = dict(flash_attention=attn_counts, ssd_scan=ssm_counts)
    for k in kernels:
        k["launches"] = path_counts.get(k["name"], counts)[k["name"]]
        if k["name"] in layer_counts:
            k["launches_layer"] = layer_counts[k["name"]][k["name"]]
        if k["name"] in ("tick_scatter", *TICK_PATH):
            k["launches_main"] = counts[k["name"]]
        if k["name"] in HOST_PATH:
            k["launches_host"] = host_counts[k["name"]]
        if k["name"] == "bucket_apply":
            # the server step's device operations a tick (phase
            # server_step): the kernel's route and the separate-launch one
            k["server_ops_per_tick"] = {
                tag: {"kernel": r["new"], "separate_launch_route": r["old"]}
                for tag, r in server_ops.items()}
        if k["name"] == "clip_accumulate":
            k.update(dp_split)
        if k["name"] in TRAIN_PATH:
            k["launches_model"] = train_counts["device"][k["name"]]
            k["launches_model_host"] = train_counts["host"].get(k["name"],
                                                                0)
            k.update(train["kernels"].get(k["name"], {}))
        if k["name"] == "tick_scatter":
            # the fused launch at model D (the engines launch its passes)
            k.update(train["kernels"]["tick_scatter"])
            k["launches_trace"] = trace_counts[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # then each kernel's own extra keys (other shapes and dtypes, the
    # main run's and the host engine's launches)
    print(json.dumps({"kernels": [
        {**{key: k[key] for key in keys},
         **{key: v for key, v in k.items() if key not in keys}}
        for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
