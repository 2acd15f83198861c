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
On a mesh of several ranks (``launch/mesh.py`` ``make_rank_mesh``) the
process holds one part: every leaf a DTensor whose local tensor is this
rank's block (``place_state``), the reference's ``device_put`` over a
multi-process job; on a mesh of one rank, the plain leaves.  Every rank
holds the same global tree (the same seeded draw, or a checkpoint's
leaves) and keeps its block; nothing is scattered.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.tensor import DTensor

from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, cuda_devices, make_mesh, mesh_of


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
    grid = tuple(mesh.shape[a] for a in mesh.axis_names)
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
    and place every leaf, one part a device of this process.  On a mesh of
    one process's devices, and on a mesh of one rank, one part a device of
    ``mesh.devices.flat``, each in the state's structure and holding that
    device's block of every leaf; a block that is a whole leaf already on
    its device is that leaf itself (no copy, as ``jax.device_put``), any
    other block a contiguous copy on the device.  A rank that holds every
    block whole runs the plain step on plain tensors (DTensor would add
    host work to every operation and change none).  On a mesh of several
    ranks, one part: ``place_state``."""
    specs = shd.tree_param_specs(state, mesh)
    if getattr(mesh, "device_mesh", None) is not None and \
            mesh.devices.size > 1:
        return [place_state(state, mesh, specs)]
    leaves = tree_leaves(state)
    blocks = [[] for _ in range(mesh.devices.size)]
    for leaf, spec in zip(leaves, tree_leaves(specs), strict=True):
        by_coord = shard_slices(tuple(leaf.shape), spec, mesh)
        for k, (coord, dev) in enumerate(zip(np.ndindex(mesh.devices.shape),
                                             mesh.devices.flat)):
            blocks[k].append(_block(leaf, by_coord[coord], dev))
    return [tree_unflatten(state, iter(b)) for b in blocks]


def _block(leaf: torch.Tensor, sl: tuple, dev: torch.device):
    """``leaf[sl]`` on ``dev``: ``leaf`` itself when that is the whole
    leaf, already there; else a contiguous copy."""
    if all(s == slice(None) for s in sl) and leaf.device == dev:
        return leaf
    return leaf[sl].to(dev, copy=True, memory_format=torch.contiguous_format)


def place_leaf(leaf: torch.Tensor, spec, mesh) -> DTensor:
    """``leaf``, the whole tensor on any device, as a DTensor on the mesh
    of ranks ``mesh`` with ``spec``'s placements
    (``sharding.spec_placements``): the local tensor is this rank's block
    (``shard_slices`` at this rank's coordinate) on this rank's device,
    ``leaf`` itself when that is all of it.  Raises on a dimension that
    its axes do not divide."""
    # here, not at import: the strategies lean on DTensor's private modules
    from repro_torch.distributed import dtensor_ops
    dtensor_ops.register()
    coord = tuple(mesh.device_mesh.get_coordinate())
    sl = shard_slices(tuple(leaf.shape), spec, mesh)[coord]
    return DTensor.from_local(_block(leaf, sl, mesh.devices[coord]),
                              mesh.device_mesh,
                              shd.spec_placements(spec, mesh),
                              run_check=False)


def place_state(state, mesh, specs):
    """``state`` on the mesh of ranks ``mesh``, every leaf placed by its
    spec in ``specs`` with ``place_leaf``, in the state's structure: the
    counterpart of ``jax.device_put`` with a ``NamedSharding`` a leaf.
    Every rank calls it with the same global tree."""
    return tree_map(lambda leaf, spec: place_leaf(leaf, spec, mesh), state,
                    specs)


def local_slices(t: DTensor) -> tuple:
    """The slices of ``t``'s global shape that this rank's local tensor
    holds (``shard_slices`` at its coordinate)."""
    mesh = mesh_of(t.device_mesh)
    spec = shd.placements_spec(t.placements, mesh.axis_names, t.dim())
    return shard_slices(tuple(t.shape), spec, mesh)[
        tuple(t.device_mesh.get_coordinate())]


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
