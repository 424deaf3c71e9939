"""Federated training of a Mamba-2 language model on the device cohort
engine, through the program's ``BatchModelTask`` and its flat adapter.

Weights: one flat f32 vector drawn on the device from the seed (a
normal draw, each leaf scaled and shifted as the configuration's
``init`` says), handed to the program as its params tree (views of the
vector) and to the reference as the vector.  Batches: ``batch_rows``
sequences of ``seq_len + 1`` tokens, uniform over the vocabulary, from
the threefry hash of the step's key; the program calls them through the
batcher interface its cohort adapter addresses by (client, round,
step), the reference through the same function.
"""
from __future__ import annotations

import dataclasses

import torch

from fedbench.reference import compare as cmp
from fedbench.reference import mamba2 as ref_m
from fedbench.reference import threefry
from fedbench.reference.protocol import PlainCohort, latency_ticks


def tokens(k0, k1, B: int, S: int, V: int, device) -> torch.Tensor:
    """(B, S + 1) int64 tokens of key words (k0, k1), device tensors."""
    n = B * (S + 1)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry.threefry2x32(k0, k1, idx >> 32, idx & threefry.M32)
    return ((x0 ^ x1) % V).reshape(B, S + 1)


class Batches:
    """The program's batcher interface over ``tokens``: ``base`` (a key
    [2] on the CPU) and ``batch_from_key``."""

    def __init__(self, seed: int, B: int, S: int, V: int, device):
        self.B, self.S, self.V, self.device = B, S, V, device
        self.base = torch.tensor(threefry.key(seed), dtype=torch.int64)

    def words(self, k0, k1) -> torch.Tensor:
        return tokens(k0, k1, self.B, self.S, self.V, self.device)

    def batch_from_key(self, key: torch.Tensor):
        key = key.to(self.device)
        return {"tokens": self.words(key[0], key[1])}


def make_weights(cfg: dict, seed: int, device) -> torch.Tensor:
    """The flat weights: one normal draw, each leaf times its scale plus
    its shift."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    spans = ref_m.spans(cfg)
    flat = torch.randn(spans[-1][1] + spans[-1][2], generator=g,
                       device=device)
    shapes = dict(ref_m.layout(cfg))
    for name, o, n in spans:
        scale, shift = cfg["init"][name]
        if scale == "fan_in":
            scale = shapes[name][-2] ** -0.5
        flat[o:o + n].mul_(scale).add_(shift)
    return flat


def params_tree(cfg: dict, flat: torch.Tensor) -> dict:
    """The program's params tree: each leaf a view of ``flat``."""
    tree: dict = {}
    for name, leaf in ref_m.unflat(cfg, flat).items():
        node = tree
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


class Bench:
    """The simulator under test and how to check it."""

    def __init__(self, cfg: dict, proto, seed: int, device):
        from repro_torch.cohort import make_simulator
        from repro_torch.configs import get_config
        from repro_torch.core import BatchModelTask
        self.cfg, self.proto, self.seed = cfg, proto, seed
        self.device = dev = torch.device(device)
        self.spans = ref_m.spans(cfg)
        self.flat0 = make_weights(cfg, seed, dev)
        m = cfg["model"]
        self.batches = Batches(seed ^ cfg["batch_salt"], m["batch_rows"],
                               m["seq_len"], cfg["vocab_size"], dev)
        pcfg = dataclasses.replace(
            get_config(cfg["arch"]),
            **{k: cfg[k] for k in cfg["program_config"]})
        task = BatchModelTask(pcfg, params_tree(cfg, self.flat0),
                              self.batches, dp_clip=proto.dp_clip,
                              dp_sigma=proto.dp_sigma, remat=m["remat"])
        self.sim = make_simulator(
            "device", task, n_clients=proto.clients,
            sizes_per_client=proto.sizes, round_stepsizes=proto.etas,
            d=proto.d, speeds=proto.speeds, latency=proto.latency,
            seed=seed, block=proto.block, dp_round_clip=proto.dp_round_clip,
            dp_rng=proto.dp_noise, device=dev)
        self.engine = self.sim.engine
        if self.engine.D != self.flat0.numel():
            raise ValueError(f"the program's model has {self.engine.D} "
                             f"weights, the configuration's layout "
                             f"{self.flat0.numel()}")
        self.flops_per_step = ref_m.step_flops(cfg, m["batch_rows"],
                                               m["seq_len"])
        self.tokens_per_step = m["batch_rows"] * m["seq_len"]
        # the program's losses, one a computed step, read at each snapshot
        self._losses = []
        inner = task.loss_and_grad

        def recorded(params, batch):
            out = inner(params, batch)
            self._losses.append(out[0])
            return out
        task.loss_and_grad = recorded
        self._task, self._inner = task, inner
        self._prev = None
        self._steps = None

    def snapshot(self, engine) -> dict:
        """The protocol's integers, each real step's loss by its address
        (client, round, offset), and the norms by leaf of each client's
        change ``w - w0``, update ``U`` and the server's change."""
        out = cmp.program_ints(engine)
        st = engine.local_state
        C, b = self.proto.clients, self.proto.b_stat
        pre_i = self._prev["i"] if self._prev else 0 * out["i"]
        pre_h = self._prev["h"] if self._prev else 0 * out["h"]
        n = (self.proto.steps_done(out["i"], out["h"])
             - self.proto.steps_done(pre_i, pre_h))
        got = [float(x) for x in self._losses]
        self._losses.clear()
        losses = {}
        # the losses of a call of many ticks carry no tick of their own:
        # only a snapshot one tick after the last is addressed
        one_tick = out["tick"] == (self._prev["tick"] if self._prev
                                   else 0) + 1
        for c in range(C if one_tick else 0):
            for j in range(int(n[c])):
                k = c * b + j
                losses[(c, int(pre_i[c]), int(pre_h[c]) + j)] = (
                    got[k] if k < len(got) else float("nan"))
        out["losses"] = losses
        self._prev = out
        out.update(self._norms(st.w, st.U, st.v))
        return out

    def _norms(self, w, U, v) -> dict:
        sp, f0 = self.spans, self.flat0
        return dict(
            w_leaves=torch.stack([cmp.leaf_norms(w[c], f0, sp)
                                  for c in range(w.shape[0])]),
            U_leaves=torch.stack([cmp.leaf_norms(U[c], None, sp)
                                  for c in range(U.shape[0])]),
            v_leaves=cmp.leaf_norms(v, f0, sp))

    def float_gaps(self, snap: dict, r: dict) -> dict:
        """``loss_gap``: the worst step's loss gap over the reference's
        loss (of a set-up tick: the window's losses carry no address);
        ``change_gap`` / ``update_gap`` / ``server_gap``: the worst leaf's
        gap of the clients' changes, the clients' updates and (at the
        window's end) the server's change (``leaf_gap``)."""
        want = self._steps.losses
        lg = cmp.worst(abs(l - want[k]) / abs(want[k]) if k in want
                       else float("inf") for k, l in snap["losses"].items())
        ref = self._norms(r["w"], r["U"], r["v"])
        gaps = {} if snap.get("window_end") else {"loss_gap": lg}
        for name, key in (("change_gap", "w_leaves"),
                          ("update_gap", "U_leaves")):
            gaps[name] = cmp.worst(cmp.leaf_gap(g, x) for g, x in
                                   zip(snap[key], ref[key]))
        if snap.get("window_end"):
            # at the set-up's ticks every client holds v and at most a
            # step: the server's change reads what the clients' does
            gaps["server_gap"] = cmp.leaf_gap(snap["v_leaves"],
                                              ref["v_leaves"])
        return gaps

    def release(self) -> None:
        """Drop the program's state."""
        self._task.loss_and_grad = self._inner
        self.sim = self.engine = self._task = self._inner = None

    def reference(self, *, tf32: bool = False,
                  rows: slice = slice(None)) -> PlainCohort:
        """The plain protocol from the same inputs, its matrix products
        in TF32 where ``tf32``, its loss over the batch rows ``rows``."""
        p = self.proto
        self._steps = ref_m.LocalSteps(
            self.cfg, self.batches.words, C=p.clients,
            base=threefry.key(int(self.batches.base[1])), clip=p.dp_clip,
            rows=rows, tf32=tf32)
        return PlainCohort(
            v0=self.flat0, C=p.clients, sizes=p.sizes, etas=p.etas, d=p.d,
            block=p.block, speeds=p.speeds,
            lat_ticks=latency_ticks(*p.latency_s, p.dt), seed=self.seed,
            noise_scale=p.dp_clip * p.dp_sigma, block_fn=self._steps,
            noise=p.dp_noise)

    def control_reference(self) -> PlainCohort:
        """The reference in the nearest precision below the
        configuration's f32 with TF32 off: TF32 matrix products."""
        return self.reference(tf32=True)

    def half_reference(self) -> PlainCohort:
        """The reference with half of each minibatch left out, the mean
        taken over the rest."""
        return self.reference(rows=slice(0, self.cfg["model"]["batch_rows"]
                                         // 2))

    def cohort_snapshot(self, ref: PlainCohort) -> dict:
        """A reference put in the program's place, read as ``snapshot``
        reads the program: its losses of the last tick, by address."""
        r = ref.snapshot()
        out = {k: r[k] for k in ("i", "h", "k", "credit", "ops", "tick",
                                 "server_k", "messages", "broadcasts")}
        seen = getattr(ref, "_seen_losses", set())
        got = ref.block_fn.losses
        out["losses"] = {k: v for k, v in got.items() if k not in seen}
        ref._seen_losses = set(got)
        out.update(self._norms(r["w"], r["U"], r["v"]))
        return out


def build(cfg: dict, proto, seed: int, device) -> Bench:
    return Bench(cfg, proto, seed, device)
