"""The paper's logistic regression on the device cohort engine.

Data: ``n_examples`` examples of ``d_features`` standard normals, labelled
by a random hyperplane through the origin with Gaussian label noise
(``label_noise``), drawn on the device from the seed; the program and
the reference get the same rows.
"""
from __future__ import annotations

import math

import torch

from fedbench.counts.models import logreg_step_flops
from fedbench.reference import compare as cmp
from fedbench.reference import logreg as ref_logreg
from fedbench.reference.protocol import PlainCohort, latency_ticks


def make_data(cfg: dict, seed: int, device):
    """(X [n, d], y [n]) f32 on the CPU, drawn on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n, d = int(cfg["n_examples"]), int(cfg["d_features"])
    w = torch.randn(d, generator=g, device=device)
    X = torch.randn(n, d, generator=g, device=device)
    noise = torch.randn(n, generator=g, device=device)
    margin = (X * w).sum(-1) / math.sqrt(d)
    y = (margin + float(cfg["label_noise"]) * noise > 0).float()
    return X.cpu(), y.cpu()


class Bench:
    """The simulator under test and how to check it."""

    def __init__(self, cfg: dict, proto, seed: int, device):
        from repro_torch.cohort import make_simulator
        from repro_torch.core import LogRegTask
        self.cfg, self.proto, self.seed = cfg, proto, seed
        self.device = torch.device(device)
        self.X, self.y = make_data(cfg, seed, self.device)
        task = LogRegTask(self.X, self.y, l2=float(cfg["l2"]),
                          dp_clip=proto.dp_clip, dp_sigma=proto.dp_sigma)
        self.sim = make_simulator(
            "device", task, n_clients=proto.clients,
            sizes_per_client=proto.sizes, round_stepsizes=proto.etas,
            d=proto.d, speeds=proto.speeds, latency=proto.latency,
            seed=seed, block=proto.block, dp_round_clip=proto.dp_round_clip,
            dp_rng=proto.dp_noise, device=self.device)
        self.engine = self.sim.engine
        self.D = int(cfg["d_features"]) + 1
        self.flops_per_step = logreg_step_flops(self.D)

    def snapshot(self, engine) -> dict:
        """What the comparison reads of the program after a tick, on
        the host: the protocol's integers and the rows."""
        out = cmp.program_ints(engine)
        st = engine.local_state
        for name in ("v", "w", "U"):
            out[name] = getattr(st, name).to("cpu", torch.float32)
        return out

    float_gaps = staticmethod(cmp.rows_gaps)

    def release(self) -> None:
        """Drop the program's state."""
        self.sim = self.engine = None

    def reference(self, dtype=torch.float32) -> PlainCohort:
        """The plain protocol from the same inputs, computed in
        ``dtype``."""
        p, dev = self.proto, self.device
        if p.dp_round_clip > 0.0:
            raise NotImplementedError("a round clip is outside the plain "
                                      "logistic regression's traffic")
        steps = ref_logreg.LocalSteps(
            self.X.to(dev), self.y.to(dev), C=p.clients, base_seed=self.seed,
            l2=float(self.cfg["l2"]), clip=p.dp_clip, dtype=dtype)
        return PlainCohort(
            v0=ref_logreg.init_model(self.D - 1, dev), C=p.clients,
            sizes=p.sizes, etas=p.etas, d=p.d, block=p.block,
            speeds=p.speeds,
            lat_ticks=latency_ticks(*p.latency_s, p.dt), seed=self.seed,
            noise_scale=p.dp_clip * p.dp_sigma, block_fn=steps,
            noise=p.dp_noise, dtype=dtype)


    def control_reference(self) -> PlainCohort:
        """The reference in the nearest precision below the
        configuration's f32 for this arithmetic, which has no matrix
        product for TF32 to change: bfloat16."""
        return self.reference(torch.bfloat16)

    def half_reference(self) -> PlainCohort:
        """The reference whose server step takes half of a tick's
        finished clients, their sum doubled (the mean over the rest)."""
        ref = self.reference()

        def aggregate(eta, sent):
            m = max(1, sent.shape[0] // 2)
            return 2.0 * (eta[:m, None] * sent[:m]).sum(0)
        ref.aggregate = aggregate
        return ref

    @staticmethod
    def cohort_snapshot(ref: PlainCohort) -> dict:
        """A reference put in the program's place, read as ``snapshot``
        reads the program."""
        return {k: (v.to("cpu", torch.float32).clone()
                    if torch.is_tensor(v) else
                    (v.copy() if hasattr(v, "copy") else v))
                for k, v in ref.snapshot().items()}


def build(cfg: dict, proto, seed: int, device) -> Bench:
    return Bench(cfg, proto, seed, device)
