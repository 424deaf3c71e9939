"""Flat-params cohort adapter: any params-tree task as a ``[C, D]`` block
task (the port's copy of ``repro.cohort.flat``).

* ``PyTreeFlattener`` — records a template's structure, leaf shapes and
  dtypes once, then maps tree <-> flat ``[D]`` f32 vector at fixed
  offsets.  Leaves of 32 bits or fewer (f32/bf16/f16) round-trip bit
  for bit, f32 being a superset of their values; ``unflatten`` of an f32
  leaf is a view of the vector, not a copy.

* ``CohortBatchModelTask`` — the whole-population view of a
  ``BatchModelTask``: ``run_block`` advances every client's row of the
  ``[C, D]`` blocks by up to ``block`` minibatch steps (forward,
  backward, optional clip, update-accumulate).  The reference's vmap
  over clients and scan over steps become loops over clients and steps;
  a step ``j >= n[c]`` is computed and masked (gradient times 0), as
  there.  Batches are addressed by (client, round, iteration) through
  the batcher's own chain — ``fold_in(fold_in(fold_in(base, client),
  round), h + j)`` — so a cohort run draws the batches the event
  simulator draws for the same ``BatchModelTask`` and
  ``SeedAddressedBatcher``, however either engine chunks a round.  The
  keys stay on the device: a block makes no host round trip.

Memory: the engines hold the population as ``[C, D]`` f32 blocks (model
and update, several more rows in the device engine's rings); a block
adds a copy of both blocks and one client's gradient and activations.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch import prng, tree
from repro_torch.cohort.tasks import _client_view
from repro_torch.core.tasks import BatchModelTask, _promoted, clip_tree
from repro_torch.telemetry import maybe_span

F32 = torch.float32


class PyTreeFlattener:
    """Static params tree <-> flat f32 vector codec (shapes fixed at
    init).  ``flatten`` ravels every leaf to f32 and concatenates in
    jax's leaf order; ``unflatten`` slices at the recorded offsets,
    reshapes and casts back to each leaf's dtype (a view for f32)."""

    def __init__(self, template):
        leaves = tree.leaves(template)
        if not leaves:
            raise ValueError("PyTreeFlattener needs a template with at "
                             "least one array leaf")
        self.skeleton = tree.tree_map(lambda l: None, template)
        self.shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(l.shape) for l in leaves)
        self.dtypes = tuple(l.dtype for l in leaves)
        for dt in self.dtypes:
            # the exactness contract up front: int/bool leaves (and f64)
            # would silently corrupt through the f32 round trip
            if not (dt.is_floating_point and dt.itemsize <= 4):
                raise TypeError(
                    f"PyTreeFlattener leaves must be <=32-bit floats "
                    f"(f32/bf16/f16) for an exact f32 round trip; got "
                    f"{str(dt).replace('torch.', '')}")
        self.sizes = tuple(int(math.prod(s)) for s in self.shapes)
        offs, o = [], 0
        for s in self.sizes:
            offs.append(o)
            o += s
        self.offsets = tuple(offs)
        self.D = o

    def flatten(self, t) -> torch.Tensor:
        """tree -> [D] f32."""
        return torch.cat([l.reshape(-1).to(F32) for l in tree.leaves(t)])

    def unflatten(self, vec: torch.Tensor, dtype=None):
        """[D] vector -> tree.  ``dtype=None`` restores each leaf's
        template dtype; pass ``torch.float32`` to keep accumulator trees
        in f32 whatever the template."""
        return tree.unflatten(self.skeleton, [
            vec[o:o + s].view(shape).to(dtype or dt)
            for o, s, shape, dt in zip(self.offsets, self.sizes, self.shapes,
                                       self.dtypes)])


class CohortBatchModelTask:
    """Whole-population view of ``BatchModelTask`` on ``device``: the
    ``CohortLogRegTask`` interface (``run_block`` / ``init_flat`` /
    ``metrics`` / ``flatten`` / ``unflatten``), so both cohort engines
    drive it unchanged.  Needs a seed-addressed batcher
    (``batch_from_key``; ``repro_torch.data.SeedAddressedBatcher``)."""

    #: the engine's span recorder (``DeviceCohortEngine.spans``); None
    #: records nothing
    spans = None

    def __init__(self, task: BatchModelTask, n_clients: int, *,
                 seed: int = 0, device=None):
        batcher = task.data_fn
        if not hasattr(batcher, "batch_from_key"):
            raise TypeError(
                "CohortBatchModelTask needs a seed-addressed batcher "
                "(data_fn with a batch_from_key method, e.g. "
                "repro_torch.data.SeedAddressedBatcher); a host-callable "
                f"batcher like {type(batcher).__name__} cannot address "
                "batches by (client, round, iteration)")
        self.task = task
        self.C = int(n_clients)
        self.device = torch.device(device if device is not None
                                   else task.device)
        self.flattener = PyTreeFlattener(task.template)
        self.D = self.flattener.D
        # the batcher's base key: the event simulator (data_fn(c, i, h))
        # and the block draw the same batch for the same address
        self.base_keys = prng.fold_in(batcher.base.to(self.device),
                                      torch.arange(self.C,
                                                   device=self.device))

    def for_clients(self, lo: int, hi: int) -> "CohortBatchModelTask":
        """The task over clients ``[lo, hi)`` of the population: batches
        keyed by the global client index, the model shared."""
        return _client_view(self, lo, hi)

    # -- flat layout -------------------------------------------------------
    def flatten(self, t) -> torch.Tensor:
        return self.flattener.flatten(t).to(self.device)

    def unflatten(self, vec: torch.Tensor):
        return self.flattener.unflatten(vec)

    def init_flat(self) -> torch.Tensor:
        return self.flatten(self.task.init_model())

    def metrics(self, vec: torch.Tensor) -> Dict[str, float]:
        return self.task.metrics(self.flattener.unflatten(vec))

    # -- batched compute ---------------------------------------------------
    def run_block(self, w, U, i, h, n, eta, block: int):
        """Advance every client by up to ``block`` minibatch steps.

        w, U: [C, D]; i, h, n: [C] int (round, in-round offset, steps to
        take this call); eta: [C] f32.  Returns new blocks (the inputs
        are not written).  Each step: g = grad of the loss (clipped when
        ``dp_clip > 0``) times ``j < n[c]``; u += g; p -= eta[c] * g, cast
        back to the leaf's dtype.

        With a recorder in ``spans``: ``client_block.clone`` (the round
        keys and the copies of both blocks), per client and step ``step``
        (allocator counters) over ``batch``, ``loss_and_grad`` (device
        time) and ``update`` (clip and update), and per client
        ``client_block.writeback``."""
        task, flt, rec = self.task, self.flattener, self.spans
        clip = task.dp_clip
        batch_from_key = task.data_fn.batch_from_key
        with maybe_span(rec, "client_block.clone"):
            round_keys = prng.fold_in(self.base_keys, i.to(self.device))
            h64 = h.to(device=self.device, dtype=torch.int64)
            w_out, U_out = w.clone(), U.clone()
        for c in range(self.C):
            # f32 leaves are views of the output rows, updated in place;
            # narrower ones are copies, written back after the steps
            params = tree.leaves(flt.unflatten(w_out[c]))
            upd = tree.leaves(flt.unflatten(U_out[c], dtype=F32))
            eta_c = eta[c]
            for j in range(block):
                with maybe_span(rec, "step", alloc=True):
                    with maybe_span(rec, "batch"):
                        batch = batch_from_key(prng.fold_in(round_keys[c],
                                                            h64[c] + j))
                    with maybe_span(rec, "loss_and_grad", device=True):
                        _, g = task.loss_and_grad(
                            tree.unflatten(flt.skeleton, params), batch)
                    with maybe_span(rec, "update"):
                        if clip > 0.0:
                            g = tree.leaves(clip_tree(g, clip))
                        act = (j < n[c]).to(F32)
                        with torch.no_grad():
                            for p, u, gl in zip(params, upd, g):
                                gl = _promoted(gl) * act
                                u.add_(gl)
                                p.copy_(_promoted(p) - eta_c * gl)
            with maybe_span(rec, "client_block.writeback"):
                for o, s, p in zip(flt.offsets, flt.sizes, params):
                    if p.dtype != F32:
                        w_out[c, o:o + s] = p.reshape(-1).to(F32)
        return w_out, U_out
