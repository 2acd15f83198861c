"""Device meshes: the production shapes (16x16 single pod, 2x16x16
multi-pod) and the host's own devices.

The reference's ``launch/mesh.py`` over ``torch.device``s.  A ``Mesh`` is
the devices laid out in a numpy array, one dimension a named axis; the
sharding rules (``distributed/sharding.py``) read its ``axis_names`` and
``shape``, and ``runtime/elastic.py`` places a tree on it, one part a
device.  A list of ``torch.device("meta")`` gives a mesh of any size for
shapes only: the port's stand-in for the reference's virtual devices.
The devices default to every visible CUDA device; with none, the
functions raise.

A mesh of ranks (``make_rank_mesh``; ``make_host_mesh`` under an
initialised process group) is the reference's mesh over a multi-process
job: one rank a device (``cuda:LOCAL_RANK``, or the CPU), each rank a
process.  Its ``Mesh`` carries a ``torch.distributed.device_mesh.
DeviceMesh`` of the same shape and axis names, on which
``runtime/elastic.py`` places a tree as DTensors and the train step runs
SPMD.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.device import resolve_device


class Mesh:
    """``devices`` (a numpy object array of ``torch.device``, one dimension
    an axis) with ``axis_names``; ``shape`` maps each axis to its size, in
    order.  ``device_mesh`` is the ``DeviceMesh`` of a mesh of ranks (each
    entry of ``devices`` then the device of the rank at that coordinate),
    ``None`` for a mesh of one process's devices."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device_mesh: DeviceMesh | None = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.device_mesh = device_mesh

    def __repr__(self) -> str:
        kind = "ranks" if self.device_mesh is not None else "devices"
        return f"Mesh({self.shape}, {kind}={list(self.devices.flat)})"


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises when there is none."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _indexed(device: torch.device | str) -> torch.device:
    """``device`` with its index (``cuda`` is the current CUDA device), so
    that it compares equal to a tensor's ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device(device)
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(shape: tuple[int, ...], axis_names: Sequence[str],
              devices: Sequence[torch.device | str] | None = None) -> Mesh:
    """``devices`` (default: every visible CUDA device) in order as a mesh
    of ``shape``; raises unless their count is the shape's size, as
    ``jax.make_mesh`` does."""
    devices = cuda_devices() if devices is None else devices
    devs = [_indexed(d) for d in devices]
    if len(devs) != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} devices, "
                         f"got {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Sequence[torch.device | str] | None = None
                         ) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def rank_device(device: torch.device | str, rank: int | None = None
                ) -> torch.device:
    """The device of ``rank`` (default: this process's) in a job on
    ``device``'s type: the CPU, or ``cuda:LOCAL_RANK``, the rank modulo
    ``LOCAL_WORLD_SIZE`` (as ``torchrun`` numbers ranks; the visible card
    count without it)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                  torch.cuda.device_count()))
    return torch.device("cuda", rank % per_host)


def make_rank_mesh(shape: tuple[int, ...], axis_names: Sequence[str],
                   device: torch.device | str) -> Mesh:
    """The ranks of the initialised process group, in order, as a mesh of
    ``shape`` (rank r at the r-th coordinate in C order, as ``make_mesh``
    lays out devices), paired with a ``DeviceMesh`` of the same shape and
    axis names.  ``device`` is the job's device type (``cuda`` or the
    CPU).  Makes this rank's card the current CUDA device.  Raises unless
    the world size is the shape's size.  Every rank calls it
    (``DeviceMesh`` makes a process group an axis)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh of ranks needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    mine = rank_device(device)
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    grid = np.empty(world, dtype=object)
    grid[:] = [rank_device(mine, r) for r in range(world)]
    dm = DeviceMesh(mine.type, torch.arange(world).reshape(shape),
                    mesh_dim_names=tuple(axis_names))
    return Mesh(grid.reshape(shape), axis_names, dm)


def mesh_of(device_mesh: DeviceMesh) -> Mesh:
    """The ``Mesh`` of a DTensor's ``DeviceMesh``: its axis names and
    shape, each coordinate the device of the rank there."""
    ranks = device_mesh.mesh.numpy()
    grid = np.empty(ranks.size, dtype=object)
    grid[:] = [rank_device(device_mesh.device_type, int(r))
               for r in ranks.flat]
    return Mesh(grid.reshape(ranks.shape), device_mesh.mesh_dim_names,
                device_mesh)


def make_host_mesh(devices: Sequence[torch.device | str] | None = None,
                   device: torch.device | str = "cuda") -> Mesh:
    """Whatever this host actually has, or ``devices``: an (n, 1) mesh.
    Under an initialised process group and with no ``devices``, every
    rank's device as (world, 1) (``make_rank_mesh`` on ``device``'s type,
    the card unless the caller asks for the CPU): the reference's
    ``make_host_mesh`` over a multi-process job."""
    if devices is None and dist.is_available() and dist.is_initialized():
        return make_rank_mesh((dist.get_world_size(), 1), ("data", "model"),
                              device)
    devices = cuda_devices() if devices is None else devices
    if not devices:
        raise ValueError("a host mesh needs at least one device")
    return make_mesh((len(devices), 1), ("data", "model"), devices)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh, *names: str) -> int:
    s = 1
    for n in names:
        if n in mesh.axis_names:
            s *= mesh.shape[n]
    return s
