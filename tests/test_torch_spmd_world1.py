"""The sharded token-LM train step at world size 1, in this process (a
gloo group over a ``HashStore``, the (1, 1) mesh of ranks): on a (1, 1)
mesh DTensor runs the same aten ops on the same local tensors as the plain
step, so losses, metrics and every parameter and optimizer-state leaf are
bit-equal to the plain step's, for AdamW on four archs (gemma2-2b with
remat "full"; the ten at four ranks: ``test_torch_spmd_archs.py`` and
its siblings) and for the 8-bit AdamW and Adafactor, whose state is placed
as ``state_specs`` says.  Also the spec <-> placements map
(``distributed/sharding.py``) for the ten archs at full width on the
production meshes, a ``Checkpointer`` round trip of a DTensor state,
``reshard_state``, which keeps a world of one plain, and when the DTensor
strategies of ``distributed/dtensor_ops.py`` are registered."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_spmd as h
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import PartitionSpec as P
from repro_torch.core.tree import tree_leaves
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import registry
from repro_torch.runtime.elastic import place_state, reshard_state
from repro_torch.training import optimizer as opt_lib


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_rank_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def _placed(params, mesh):
    """``params`` as DTensors on the (1, 1) mesh of ranks, each local
    tensor the whole leaf (``reshard_state`` keeps a world of one plain)."""
    return place_state(params, mesh, shd.tree_param_specs(params, mesh))


def _step_both(arch, mesh, ocfg, n=2, **upd):
    cfg = dataclasses.replace(h.model(arch)[0], **upd)
    api = registry.get_model(arch, cfg)
    params = h.init_params(api)
    batch = {k: torch.from_numpy(v) for k, v in h.batch(cfg).items()}
    plain_p = copy.deepcopy(params)
    plain = {"params": plain_p, "opt": opt_lib.init_opt_state(plain_p, ocfg)}
    placed = _placed(params, mesh)
    sharded = {"params": placed, "opt": opt_lib.init_opt_state(placed, ocfg)}
    step = steps.make_train_step(api, ocfg, donate=True)
    for _ in range(n):
        plain, pm = step(plain, batch)
        sharded, sm = step(sharded, batch)
        for k in pm:
            assert isinstance(sm[k], DTensor)
            assert torch.equal(sm[k].to_local(), pm[k]), k
    return plain, sharded, params


@pytest.mark.parametrize("arch,upd", [
    ("gemma2-2b", {"remat": "full"}), ("deepseek-v3-671b", {}),
    ("xlstm-350m", {}), ("zamba2-7b", {})])
def test_world_one_step_is_bit_equal(mesh, arch, upd):
    plain, sharded, _ = _step_both(arch, mesh, h.ocfg(), **upd)
    for a, b in zip(tree_leaves(sharded), tree_leaves(plain), strict=True):
        assert isinstance(a, DTensor)
        assert torch.equal(a.to_local(), b)


@pytest.mark.parametrize("name", ["adamw8bit", "adafactor"])
def test_world_one_optimizers_placed_by_state_specs(mesh, name):
    ocfg = dataclasses.replace(h.ocfg(), name=name)
    plain, sharded, params = _step_both("yi-6b", mesh, ocfg)
    for a, b in zip(tree_leaves(sharded), tree_leaves(plain), strict=True):
        assert torch.equal(a.to_local(), b)  # int8 codecs leaf by leaf
    specs = opt_lib.state_specs(shd.tree_param_specs(params, mesh), params,
                                ocfg)
    got = [shd.placements_spec(t.placements, mesh.axis_names, t.dim())
           for t in tree_leaves(sharded["opt"])]
    assert got == tree_leaves(specs)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_spec_placements_round_trip(arch):
    params = registry.get_model(arch).init(torch.Generator(),
                                           device="meta")
    for mesh in (FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16,
                                                       model=16)):
        for leaf, spec in zip(tree_leaves(params), tree_leaves(
                shd.tree_param_specs(params, mesh))):
            pl = shd.spec_placements(spec, mesh)
            assert len(pl) == len(mesh.axis_names)
            back = shd.placements_spec(pl, mesh.axis_names, leaf.dim())
            assert tuple(back) == tuple(spec) + (None,) * (
                leaf.dim() - len(spec))


def test_spec_placements_by_axis():
    mesh = FakeMesh(pod=2, data=4, model=2)
    assert shd.spec_placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.spec_placements(P(), mesh) == (Replicate(),) * 3
    for bad in (P(("data", "pod")), P("rows"), P("data", "data")):
        with pytest.raises(ValueError):
            shd.spec_placements(bad, mesh)


def test_checkpointer_round_trips_a_dtensor_state(mesh, tmp_path):
    _, sharded, _ = _step_both("yi-6b", mesh, h.ocfg(), n=1)
    ckpt = Checkpointer(tmp_path)
    ckpt.save(1, sharded, blocking=True)
    d = tmp_path / "step_1"
    assert sorted(p.name for p in d.iterdir()) == ["manifest.json",
                                                   "shard_0.npz"]
    restored, step = ckpt.restore(sharded)
    assert step == 1
    for a, b in zip(tree_leaves(restored), tree_leaves(sharded)):
        assert isinstance(a, DTensor) and a.placements == b.placements
        assert torch.equal(a.to_local(), b.to_local())
    fresh = _zeros_like(sharded)
    assert ckpt.restore_into(fresh) == 1
    for a, b in zip(tree_leaves(fresh), tree_leaves(sharded)):
        assert torch.equal(a.to_local(), b.to_local())


def _zeros_like(tree):
    """A state of ``tree``'s placements, every local tensor zero."""
    out = copy.deepcopy(tree)
    for t in tree_leaves(out):
        t.to_local().zero_()
    return out


def test_gradients_redistributed_to_parameter_placements(mesh):
    cfg, api = h.model("yi-6b")
    placed = _placed(h.init_params(api), mesh)
    batch = {k: torch.from_numpy(v) for k, v in h.batch(cfg).items()}
    loss, grads = steps.loss_and_grads(api, placed, batch)
    assert all(p.is_replicate() for p in loss.placements)
    for g, p in zip(grads, tree_leaves(placed), strict=True):
        assert g.placements == p.placements
    assert np.isfinite(float(loss.to_local()))


def test_reshard_state_keeps_a_world_of_one_plain(mesh):
    """On a mesh of one rank every block is the whole leaf: the leaves
    themselves, plain tensors, so the step runs plain."""
    params = h.init_params(h.model("yi-6b")[1])
    (part,) = reshard_state(params, mesh)
    assert all(a is b for a, b in zip(tree_leaves(part), tree_leaves(params),
                                      strict=True))
    assert steps.rank_mesh(part) is None


def test_strategies_registered_only_for_a_mesh_of_ranks():
    """Importing the spec rules, the steps, the entry point and the
    checkpointer leaves DTensor's tables as torch has them:
    ``distributed/dtensor_ops.py`` is imported, and registers, when a leaf
    is first placed on a mesh of ranks."""
    code = ("import sys\n"
            "import repro_torch.distributed.sharding, repro_torch.launch.train"
            "\nimport repro_torch.checkpoint.checkpointer\n"
            "sys.exit('repro_torch.distributed.dtensor_ops' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=h.ROOT,
                          env={**os.environ, "PYTHONPATH": str(h.ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_strategies_refuse_an_unchecked_torch(monkeypatch):
    from repro_torch.distributed import dtensor_ops
    monkeypatch.setattr(dtensor_ops, "_registered", False)
    monkeypatch.setattr(torch, "__version__", "2.99.0+cpu")
    with pytest.raises(RuntimeError, match="checked against torch"):
        dtensor_ops.register()
