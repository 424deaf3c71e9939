"""``DeviceCohortSimulator`` — the user-facing entry point of the port.

Same constructor vocabulary and ``run()`` result schema as the
reference's ``repro.cohort.DeviceCohortSimulator``, plus ``device``:
``None`` means the card, and without CUDA the simulator raises unless
the caller asks for ``device="cpu"`` (the plain PyTorch versions of the
kernels, as the tests run it).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.cohort.device import DeviceCohortEngine, resolve_device
from repro_torch.cohort.tasks import CohortLogRegTask
from repro_torch.core.tasks import LogRegTask


def as_cohort_task(task, n_clients: int, *, seed: int = 0, device=None):
    """Adapt a ``LogRegTask`` (or pass through a cohort task)."""
    if isinstance(task, CohortLogRegTask):
        return task
    if isinstance(task, LogRegTask):
        return CohortLogRegTask(task, n_clients, seed=seed,
                                device=resolve_device(device))
    raise NotImplementedError(
        f"no cohort adapter for {type(task).__name__}: the model-scale "
        "path is ROADMAP Queue 1 item 11")


class DeviceCohortSimulator:
    """Front end of the device-resident engine."""

    def __init__(self, task, *, n_clients: int, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency=None, seed: int = 0, block: int = 64,
                 dp_round_clip: float = 0.0, scenario=None, trace=None,
                 dp_delta: float = 1e-5, strategy=None,
                 dp_rng: str = "operand", fuse_ticks: bool = True,
                 device=None):
        self.task = task
        self.device = resolve_device(device)
        self.ctask = as_cohort_task(task, n_clients, seed=seed,
                                    device=self.device)
        src_task = self.ctask.task
        self.engine = DeviceCohortEngine(
            self.ctask, sizes_per_client=sizes_per_client,
            round_stepsizes=round_stepsizes, d=d, speeds=speeds,
            latency=latency, seed=seed, block=block,
            dp_sigma=src_task.dp_sigma, dp_clip=src_task.dp_clip,
            dp_round_clip=dp_round_clip, scenario=scenario, trace=trace,
            dp_delta=dp_delta, strategy=strategy, dp_rng=dp_rng,
            fuse_ticks=fuse_ticks)

    @property
    def server_model(self):
        return self.ctask.unflatten(self.engine.state.v)

    @property
    def total_messages(self) -> int:
        return self.engine.total_messages

    @property
    def total_broadcasts(self) -> int:
        return self.engine.total_broadcasts

    def run(self, *, max_rounds: int, eval_every: int = 1,
            eval_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
            max_ticks: Optional[int] = None) -> Dict[str, Any]:
        return self.engine.run(max_rounds=max_rounds,
                               eval_every=eval_every, eval_fn=eval_fn,
                               max_ticks=max_ticks)


def make_simulator(engine, task, **kw):
    """Engine switch: ``engine`` is ``"device"`` or an ``FLConfig`` whose
    ``engine`` / ``cohort_block`` / ``scenario`` / ``aggregation`` fields
    select and tune it.  The host cohort engine and the event simulator
    are ROADMAP Queue 1 items 6 and 9."""
    if not isinstance(engine, str):
        cfg = engine
        engine = cfg.engine
        kw.setdefault("block", cfg.cohort_block)
        if cfg.scenario is not None:
            kw.setdefault("scenario", cfg.scenario)
        if cfg.aggregation is not None:
            kw.setdefault("strategy", cfg.aggregation)
    if engine == "device":
        return DeviceCohortSimulator(task, **kw)
    if engine in ("cohort", "event"):
        item = 6 if engine == "cohort" else 9
        raise NotImplementedError(
            f"engine={engine!r} is not ported yet (ROADMAP Queue 1 item "
            f"{item})")
    raise ValueError(
        f"unknown engine {engine!r} (want 'event'|'cohort'|'device')")
