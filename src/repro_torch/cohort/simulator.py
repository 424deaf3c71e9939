"""``CohortSimulator`` / ``DeviceCohortSimulator`` — the port's front
ends of the host-loop and device-resident cohort engines, and
``make_simulator``, the engine switch over them and the event simulator.

Same constructor vocabulary and ``run()`` result schema as the
reference's ``repro.cohort`` simulators, plus ``device``: ``None`` means
the card, and without CUDA a simulator raises unless the caller asks for
``device="cpu"`` (the plain PyTorch versions of the kernels, as the
tests run it).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.cohort.device import DeviceCohortEngine, resolve_device
from repro_torch.cohort.engine import CohortEngine
from repro_torch.cohort.flat import CohortBatchModelTask
from repro_torch.cohort.tasks import CohortLogRegTask
from repro_torch.core.tasks import BatchModelTask, LogRegTask


def as_cohort_task(task, n_clients: int, *, seed: int = 0, device=None):
    """Adapt a ``LogRegTask`` or a ``BatchModelTask`` to the cohort
    engines on ``device`` (or pass through a cohort task: any object
    with ``run_block``)."""
    if hasattr(task, "run_block"):
        return task
    if isinstance(task, LogRegTask):
        return CohortLogRegTask(task, n_clients, seed=seed,
                                device=resolve_device(device))
    if isinstance(task, BatchModelTask):
        return CohortBatchModelTask(task, n_clients, seed=seed,
                                    device=resolve_device(device))
    raise TypeError(f"no cohort adapter for {type(task).__name__}; "
                    "provide an object with run_block/init_flat/metrics")


class _Front:
    """What the front ends share: the server model and the counters."""

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


class CohortSimulator(_Front):
    """Front end of the host-loop engine (``repro_torch.cohort.engine``):
    the protocol in Python per tick, the ``[C, D]`` work on ``device``."""

    def __init__(self, task, *, n_clients: int, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency_fn: Optional[Callable] = None, seed: int = 0,
                 block: int = 64, dp_round_clip: float = 0.0,
                 scenario=None, trace=None, dp_delta: float = 1e-5,
                 strategy=None, device=None):
        self.task = task
        self.device = resolve_device(device)
        self.ctask = as_cohort_task(task, n_clients, seed=seed,
                                    device=self.device)
        src_task = self.ctask.task
        self.engine = CohortEngine(
            self.ctask, sizes_per_client=sizes_per_client,
            round_stepsizes=round_stepsizes, d=d, speeds=speeds,
            latency_fn=latency_fn, seed=seed, block=block,
            dp_sigma=src_task.dp_sigma, dp_clip=src_task.dp_clip,
            dp_round_clip=dp_round_clip, scenario=scenario, trace=trace,
            dp_delta=dp_delta, strategy=strategy)


class DeviceCohortSimulator(_Front):
    """Front end of the device-resident engine.  ``mesh``: a 1-D
    ``clients`` mesh (``repro_torch.sharding.cohort_mesh``) to cut the
    population's ``[C, ...]`` state over its ranks; None (the default)
    keeps it on one device with no process group."""

    def __init__(self, task, *, n_clients: int, sizes_per_client,
                 round_stepsizes: Sequence[float], d: int = 1,
                 speeds: Optional[Sequence[float]] = None,
                 latency=None, seed: int = 0, block: int = 64,
                 dp_round_clip: float = 0.0, scenario=None, trace=None,
                 dp_delta: float = 1e-5, strategy=None,
                 dp_rng: str = "operand", fuse_ticks: bool = True,
                 device=None, mesh=None):
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
            fuse_ticks=fuse_ticks, mesh=mesh)

    @property
    def server_model(self):
        return self.ctask.unflatten(self.engine.local_state.v)


def make_simulator(engine, task, **kw):
    """Engine switch: ``engine`` is ``'event' | 'cohort' | 'device'``, or
    an ``FLConfig`` whose ``engine`` / ``cohort_block`` / ``scenario`` /
    ``aggregation`` fields select and tune the engine.  ``device`` (the
    card when omitted) is passed through to all three; ``mesh`` (a
    ``clients`` mesh) to the device engine only."""
    if not isinstance(engine, str):
        cfg = engine
        engine = cfg.engine
        if engine in ("cohort", "device"):
            kw.setdefault("block", cfg.cohort_block)
        if cfg.scenario is not None:
            kw.setdefault("scenario", cfg.scenario)
        if cfg.aggregation is not None:
            kw.setdefault("strategy", cfg.aggregation)
    if engine != "device" and kw.pop("mesh", None) is not None:
        raise ValueError(f"engine={engine!r} takes no mesh: only the "
                         f"device engine cuts its state over ranks")
    if engine == "cohort":
        return CohortSimulator(task, **kw)
    if engine == "device":
        if kw.pop("latency_fn", None) is not None:
            raise ValueError(
                "engine='device' takes latency=<spec>, not a host "
                "latency_fn callable (see repro_torch.cohort.device)")
        return DeviceCohortSimulator(task, **kw)
    if engine == "event":
        from repro_torch.core.simulator import AsyncFLSimulator
        kw.pop("block", None)
        return AsyncFLSimulator(task, **kw)
    raise ValueError(
        f"unknown engine {engine!r} (want 'event'|'cohort'|'device')")
