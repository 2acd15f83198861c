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
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device


class Mesh:
    """``devices`` (a numpy object array of ``torch.device``, one dimension
    an axis) with ``axis_names``; ``shape`` maps each axis to its size, in
    order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


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


def make_host_mesh(devices: Sequence[torch.device | str] | None = None
                   ) -> Mesh:
    """Whatever this host actually has, or ``devices``: an (n, 1) mesh."""
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
