"""Elastic scaling: rebuild the mesh from the surviving device set and
reshard a state onto it.

Flow on node failure: the job restarts on N' < N devices, calls
``make_elastic_mesh()`` to build the largest (data, model) mesh the
survivors support (model axis preserved if possible — TP degree is baked
into layer math far less than DP is), re-derives parameter specs, and
places the restored state with ``reshard_state``.  The global batch is
kept constant by scaling per-device batch.

The reference's ``runtime/elastic.py`` in one process: where the reference
``device_put``s each leaf with a ``NamedSharding``, ``reshard_state``
returns one part a device of the mesh, each in the state's structure and
holding that device's block of every leaf (``shard_slices``, the
counterpart of ``NamedSharding.devices_indices_map``), as
``distributed/sharding.py`` ``shard_state`` does for the stream state.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, cuda_devices, make_mesh


def make_elastic_mesh(preferred_model: int = 16,
                      devices: Sequence[torch.device | str] | None = None
                      ) -> Mesh:
    devices = cuda_devices() if devices is None else list(devices)
    n = len(devices)
    model = preferred_model
    while model > 1 and n % model:
        model //= 2
    return make_mesh((n // model, model), ("data", "model"),
                     devices[: (n // model) * model])


def _parts(entry, mesh) -> tuple[int, list[str]]:
    """How many blocks a spec entry splits its dimension into, and the mesh
    axes it splits over (the first one major)."""
    axes = [] if entry is None else \
        list(entry) if isinstance(entry, tuple) else [entry]
    return math.prod(mesh.shape[a] for a in axes), axes


def shard_slices(shape: Sequence[int], spec, mesh) -> dict:
    """Each mesh coordinate (a tuple of indices, one an axis) mapped to the
    tuple of slices that device holds of a leaf of ``shape`` under
    ``spec``: ``slice(None)`` for a dimension it holds whole.  Raises on a
    dimension that its axes do not divide."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    grid = mesh.devices.shape
    coords = list(np.ndindex(grid))
    index = np.indices(grid)
    cols = []
    for size, entry in zip(shape, spec):
        n, axes = _parts(entry, mesh)
        if size % n:
            raise ValueError(f"dimension of size {size} does not split over "
                             f"{axes} ({n} blocks)")
        if n == 1:
            cols.append([slice(None)] * len(coords))
            continue
        k = np.zeros(grid, dtype=np.int64)  # the block each device holds
        for a in axes:
            k = k * mesh.shape[a] + index[mesh.axis_names.index(a)]
        block = size // n
        blocks = [slice(i * block, (i + 1) * block) for i in range(n)]
        cols.append([blocks[i] for i in k.ravel()])
    if not cols:
        return dict.fromkeys(coords, ())
    return dict(zip(coords, zip(*cols)))


def reshard_state(state, mesh) -> list:
    """Re-derive specs for ``state`` on ``mesh`` (``tree_param_specs``)
    and place every leaf: one part a device of ``mesh.devices.flat``, each
    in the state's structure and holding that device's block of every
    leaf.  A block that is a whole leaf already on its device is that leaf
    itself (no copy, as ``jax.device_put``); any other block is a
    contiguous copy on the device."""
    specs = shd.tree_param_specs(state, mesh)
    leaves = tree_leaves(state)
    blocks = [[] for _ in range(mesh.devices.size)]
    for leaf, spec in zip(leaves, tree_leaves(specs), strict=True):
        by_coord = shard_slices(tuple(leaf.shape), spec, mesh)
        for k, (coord, dev) in enumerate(zip(np.ndindex(mesh.devices.shape),
                                             mesh.devices.flat)):
            sl = by_coord[coord]
            whole = all(s == slice(None) for s in sl)
            if whole and leaf.device == dev:
                blocks[k].append(leaf)
            else:
                blocks[k].append(leaf[sl].to(
                    dev, copy=True, memory_format=torch.contiguous_format))
    return [tree_unflatten(state, iter(b)) for b in blocks]


def per_host_batch(global_batch: int, mesh) -> int:
    """Keep the global batch constant across elastic resizes.  Divides by
    the ``torch.distributed`` world size (1 with no process group), where
    the reference divides by ``jax.process_count()``: not by the data
    axes it asserts on."""
    n_data = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    assert global_batch % n_data == 0, (global_batch, n_data)
    world = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    return global_batch // world
