"""Per-device argument bytes of the dry run's cells against the
reference's own spec trees and shapes.

For the ten archs at full width, on the single-pod (16 x 16) and
multi-pod (2 x 16 x 16) production meshes (stand-ins with the sizes, as
``test_torch_sharding.py`` uses), the bytes a device holds of a train
step's arguments (parameters, optimizer state, batch) and of a decode
step's (parameters, ``decode_32k`` cache, one-token batch), from
``launch/dryrun.py`` ``arg_shardings`` (``with_shardings`` blocks), equal
the bytes worked out from the reference's ``tree_param_specs``,
``state_specs``, ``batch_specs`` and ``tree_cache_specs`` over its
``jax.eval_shape`` shapes: each leaf's dims divided by the product of its
spec entry's axes, rounded up.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import base as j_base
from repro.distributed import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro.training import optimizer as j_opt
from repro_torch.configs.base import DECODE_32K, TRAIN_4K
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.models import registry
from test_torch_sharding import FakeMesh

MESHES = {"pod": FakeMesh(data=16, model=16),
          "multipod": FakeMesh(pod=2, data=16, model=16)}


@pytest.fixture(autouse=True)
def no_registered_axes():
    shd.set_activation_axes(None)
    j_shd.set_activation_axes(None)
    yield
    shd.set_activation_axes(None)
    j_shd.set_activation_axes(None)


def j_bytes(shapes, specs, mesh) -> int:
    """A device's bytes of a reference tree placed by its specs."""
    leaves = jax.tree.leaves(shapes)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        block = 1
        for d, e in zip(leaf.shape, entries):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            block *= -(-d // math.prod(mesh.shape[a] for a in axes))
        total += block * np.dtype(leaf.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def j_params(arch: str):
    return jax.eval_shape(j_registry.get_model(arch).init,
                          jax.random.PRNGKey(0))


def reference_bytes(arch: str, shape, mesh) -> int:
    api = j_registry.get_model(arch)
    cfg = api.cfg
    params = j_params(arch)
    pspecs = j_shd.tree_param_specs(params, mesh)
    bshapes = j_steps.batch_shapes(cfg, shape)
    total = j_bytes(params, pspecs, mesh) + j_bytes(
        bshapes, j_shd.batch_specs(bshapes, mesh), mesh)
    if shape.kind == "train":
        ocfg = j_opt.OptimizerConfig(name=cfg.optimizer)
        opt = jax.eval_shape(lambda p: j_opt.init_opt_state(p, ocfg), params)
        return total + j_bytes(opt, j_opt.state_specs(pspecs, params, ocfg),
                               mesh)
    cache = jax.eval_shape(
        lambda: api.init_cache(shape.global_batch, shape.seq_len))
    return total + j_bytes(cache, j_shd.tree_cache_specs(
        cache, mesh, shape.global_batch), mesh)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_argument_bytes_equal_reference_specs(arch):
    for shape in (TRAIN_4K, DECODE_32K):
        cfg, _, args, _ = dryrun.build(arch, shape, torch.device("meta"))
        j_shape = j_base.shape_by_name(shape.name)
        for name, mesh in MESHES.items():
            got = sum(s.block_bytes for s in tree_leaves(
                dryrun.arg_shardings(cfg, shape, args, mesh)))
            assert got == reference_bytes(arch, j_shape, mesh), (
                arch, shape.name, name)
