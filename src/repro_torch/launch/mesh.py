"""Production meshes over a fake process group, and small real meshes.

The reference's production meshes are TPU v5e pods lowered against 256
or 512 host-platform devices.  The port's are ``DeviceMesh``es over
PyTorch's ``"fake"`` process-group backend: one process stands for every
rank, collectives return at once, and with ``FakeTensorMode`` nothing is
allocated, so a 512-rank plan runs on one machine.  The fake backend is
brought up only inside ``make_fake_mesh``; without it the call raises
and never falls back to a smaller world.

Defined as FUNCTIONS so importing this module touches no process group.
"""
from __future__ import annotations

import math
import socket
from typing import Sequence

from repro_torch.devices import resolve_device


def _fake_world(n: int) -> None:
    """A fake default process group of exactly ``n`` ranks, this process
    rank 0 (an earlier fake group of another size is torn down; a real
    one is left alone and refused)."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is up: a fake "
                f"mesh needs the fake backend (destroy the group first)")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_fake_mesh(shape: Sequence[int], names: Sequence[str], *,
                   device=None):
    """A ``DeviceMesh`` of ``shape`` over a fake group of prod(shape)
    ranks.  ``device`` None is the card (``"cuda"``); ``"cpu"`` for the
    tests."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    _fake_world(math.prod(shape))
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 = 256 cards per pod; 2 pods = 512 cards when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_fake_mesh(shape, axes, device=device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(*, data: int = 1, model: int = 1, device=None):
    """Small real mesh over the process group's ranks (tests / the card
    check): with no group up, a one-rank group (NCCL on the card, gloo
    on the CPU) at a free localhost port."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, n // data)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def n_chips(mesh) -> int:
    return int(mesh.size())
