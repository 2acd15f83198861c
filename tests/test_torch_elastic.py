"""The port's meshes and elastic reshard (``launch/mesh.py``,
``runtime/elastic.py``) against the reference's, and ``launch/train.py``
placing its parameters through them.

The reference's meshes need as many JAX devices as they have entries, so
its side runs in ONE subprocess with eight host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``; no ``jit``, shapes
from ``jax.eval_shape``), which prints ``make_elastic_mesh``'s shapes and
``NamedSharding(mesh, spec).devices_indices_map(shape)`` by mesh
coordinate as JSON.  The port's ``shard_slices`` must give the same slices
exactly (integers), and ``reshard_state``'s blocks must join back to each
leaf bit for bit.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.runtime import elastic as j_elastic
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry
from repro_torch.runtime import elastic
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
COUNTS = (1, 2, 3, 4, 6, 8)
PREFERRED = (1, 2, 4, 16)
ARCH = "yi-6b"

REFERENCE = textwrap.dedent("""
    import json
    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.distributed import sharding as shd
    from repro.models import registry
    from repro.runtime.elastic import make_elastic_mesh

    devs = jax.devices()
    assert len(devs) == 8, devs
    out = {"elastic": {}, "slices": {}}
    for n in %(counts)r:
        for pref in %(preferred)r:
            m = make_elastic_mesh(pref, devices=devs[:n])
            out["elastic"][f"{n} {pref}"] = [list(m.axis_names),
                                             list(m.devices.shape)]
    cfg = registry.reduce_config(registry.get_model(%(arch)r).cfg)
    params = jax.eval_shape(registry.get_model(%(arch)r, cfg).init,
                            jax.random.PRNGKey(0))
    meshes = {
        "4x2": jax.make_mesh((4, 2), ("data", "model"), devices=devs),
        "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                               devices=devs),
        "elastic 8->4": make_elastic_mesh(preferred_model=2,
                                          devices=devs[:4]),
    }
    for name, mesh in meshes.items():
        specs = shd.tree_param_specs(params, mesh)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        rec = {"shape": list(mesh.devices.shape), "leaves": {}}
        for (path, leaf), spec in zip(flat, spec_leaves):
            idx = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            by_coord = {}
            for dev, sl in idx.items():
                coord = tuple(int(c) for c in
                              np.argwhere(mesh.devices == dev)[0])
                by_coord[str(coord)] = [[s.start, s.stop] for s in sl]
            rec["leaves"][jax.tree_util.keystr(path)] = {
                "shape": list(leaf.shape), "spec": repr(tuple(spec)),
                "by_coord": by_coord}
        out["slices"][name] = rec
    print("REFERENCE " + json.dumps(out))
""") % {"counts": COUNTS, "preferred": PREFERRED, "arch": ARCH}


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", REFERENCE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("REFERENCE "))
    return json.loads(line[len("REFERENCE "):])


def meta(n: int) -> list:
    return [torch.device("meta")] * n


def reduced_params(device="meta", seed=0):
    cfg = registry.reduce_config(registry.get_model(ARCH).cfg)
    return registry.get_model(ARCH, cfg).init(
        torch.Generator().manual_seed(seed), device=device)


PORT_MESHES = {
    "4x2": lambda: mesh_lib.make_mesh((4, 2), ("data", "model"), meta(8)),
    "2x2x2": lambda: mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                        meta(8)),
    "elastic 8->4": lambda: elastic.make_elastic_mesh(2, devices=meta(4)),
}


# ---------------------------------------------------------------- meshes


def test_make_elastic_mesh_shapes_equal_reference():
    want = reference()["elastic"]
    for n in COUNTS:
        for pref in PREFERRED:
            m = elastic.make_elastic_mesh(pref, devices=meta(n))
            assert [list(m.axis_names), list(m.devices.shape)] == \
                want[f"{n} {pref}"], (n, pref)
            assert list(m.shape.values()) == list(m.devices.shape)


@pytest.mark.parametrize("name", list(PORT_MESHES))
def test_shard_slices_equal_devices_indices_map(name):
    want = reference()["slices"][name]
    mesh = PORT_MESHES[name]()
    assert list(mesh.devices.shape) == want["shape"]
    params = reduced_params()
    specs = dict(tree_leaves_with_path(shd.tree_param_specs(params, mesh)))
    got = dict(tree_leaves_with_path(params))
    assert got.keys() == want["leaves"].keys()
    for path, rec in want["leaves"].items():
        leaf = got[path]
        assert list(leaf.shape) == rec["shape"]
        assert repr(tuple(specs[path])) == rec["spec"], path
        by_coord = elastic.shard_slices(tuple(leaf.shape), specs[path], mesh)
        assert {str(c): [[s.start, s.stop] for s in sl]
                for c, sl in by_coord.items()} == rec["by_coord"], path


def test_production_and_host_meshes():
    m = mesh_lib.make_production_mesh(devices=meta(256))
    assert m.axis_names == ("data", "model") and m.shape == \
        {"data": 16, "model": 16}
    m3 = mesh_lib.make_production_mesh(multi_pod=True, devices=meta(512))
    assert list(m3.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert mesh_lib.data_axes(m) == ("data",)
    assert mesh_lib.data_axes(m3) == ("pod", "data")
    assert mesh_lib.axis_size(m3, "pod", "data") == 32
    assert mesh_lib.axis_size(m, "pod", "model") == 16
    with pytest.raises(ValueError, match="256 devices"):
        mesh_lib.make_production_mesh(devices=meta(8))
    h = mesh_lib.make_host_mesh(["cpu"] * 3)
    assert h.shape == {"data": 3, "model": 1}
    assert list(h.devices.flat) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        mesh_lib.make_host_mesh([])
    if not torch.cuda.is_available():
        for make in (mesh_lib.make_host_mesh, mesh_lib.make_production_mesh,
                     elastic.make_elastic_mesh):
            with pytest.raises(RuntimeError, match="is_available"):
                make()


def test_shard_slices_refuses_an_indivisible_dim():
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), meta(8))
    with pytest.raises(ValueError, match="does not split"):
        elastic.shard_slices((6, 4), ("data", None), mesh)
    assert elastic.shard_slices((), (), mesh)[(3, 1)] == ()


# --------------------------------------------------------------- reshard


def join(blocks: list, mesh, spec, like: torch.Tensor) -> torch.Tensor:
    """Every device's block written back at its slices; every element
    must be written."""
    out = torch.empty_like(like)
    written = torch.zeros(like.shape, dtype=torch.bool)
    for (coord, sl), block in zip(
            elastic.shard_slices(tuple(like.shape), spec, mesh).items(),
            blocks):
        out[sl] = block
        written[sl] = True
    assert bool(written.all())
    return out


@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_reshard_state_round_trips(shape, axes):
    params = reduced_params("cpu", seed=3)
    state = {"params": params,
             "opt": opt_lib.init_opt_state(params,
                                           opt_lib.OptimizerConfig())}
    mesh = mesh_lib.make_mesh(shape, axes, ["cpu"] * 8)
    parts = elastic.reshard_state(state, mesh)
    assert len(parts) == 8
    specs = tree_leaves(shd.tree_param_specs(state, mesh))
    cols = list(zip(*(tree_leaves(p) for p in parts)))
    split = 0
    for leaf, spec, blocks in zip(tree_leaves(state), specs, cols,
                                  strict=True):
        assert torch.equal(join(list(blocks), mesh, spec, leaf), leaf)
        if any(s is not None for s in spec):
            split += 1
            assert all(b.is_contiguous() and
                       b.untyped_storage().data_ptr() !=
                       leaf.untyped_storage().data_ptr() for b in blocks)
        else:
            assert all(b is leaf for b in blocks)
    assert split > 0


def test_reshard_state_on_one_device_is_the_state_itself():
    params = reduced_params("cpu", seed=4)
    mesh = elastic.make_elastic_mesh(devices=["cpu"])
    assert mesh.shape == {"data": 1, "model": 1}
    (part,) = elastic.reshard_state(params, mesh)
    assert all(a is b for a, b in zip(tree_leaves(part), tree_leaves(params),
                                      strict=True))
    # a whole block bound for another device is copied there
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), ["meta"])
    (moved,) = elastic.reshard_state(params, mesh)
    assert all(t.device.type == "meta" for t in tree_leaves(moved))


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def test_per_host_batch_equals_reference():
    """The reference divides by its process count (1 here), not by the
    data axes it asserts on; the port by its world size (1, no group)."""
    for mesh in (FakeMesh(data=4, model=2), FakeMesh(pod=2, data=2, model=2),
                 FakeMesh(model=8)):
        for gb in (8, 16, 64, 256):
            assert elastic.per_host_batch(gb, mesh) == \
                j_elastic.per_host_batch(gb, mesh) == gb
        with pytest.raises(AssertionError):
            j_elastic.per_host_batch(6, FakeMesh(data=4, model=2))
        with pytest.raises(AssertionError):
            elastic.per_host_batch(6, FakeMesh(data=4, model=2))


# ---------------------------------------------------------- launch/train


def test_launch_train_places_by_specs_and_matches_a_direct_trainer(
        tmp_path, monkeypatch):
    """``main`` builds the (1, 1) host mesh, registers it and places the
    parameters through ``reshard_state``; its losses and final state are
    bit-equal to a ``Trainer`` run without the mesh at the same seed."""
    from repro_torch.launch import train

    placed = []
    real = elastic.reshard_state
    monkeypatch.setattr(train, "reshard_state",
                        lambda *a, **kw: placed.append(a[1]) or real(*a, **kw))
    steps, batch, seq = 4, 2, 16
    argv = ["--arch", ARCH, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--out", str(tmp_path / "main"), "--device",
            "cpu"]
    got = train.main(argv)
    assert [m.shape for m in placed] == [{"data": 1, "model": 1}]
    assert shd.axis_size("data") == 1 and shd.axis_size("model") == 1
    shd.set_activation_axes(None)

    cfg = registry.reduce_config(registry.get_model(ARCH).cfg)
    api = registry.get_model(ARCH, cfg)
    ocfg = opt_lib.OptimizerConfig(name="adamw", lr=3e-3,
                                   warmup_steps=max(steps // 20, 2),
                                   decay_steps=steps)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))

    def init_state():
        params = api.init(torch.Generator(device="cpu").manual_seed(0),
                          device="cpu")
        return {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}

    tcfg = TrainerConfig(total_steps=steps, log_every=1, ckpt_every=10,
                         out_dir=str(tmp_path / "direct"), resume=False)
    want = Trainer(tcfg, steps_lib.make_train_step(api, ocfg, donate=True),
                   init_state,
                   lambda s: {"tokens": stream.batch(batch, seq, s)["tokens"]},
                   device="cpu").run()

    def losses(out: Path) -> dict:
        recs = [json.loads(ln) for ln in
                (out / "metrics.jsonl").read_text().splitlines()]
        return {r["step"]: r["loss"] for r in recs}

    got_l, want_l = losses(tmp_path / "main"), losses(tmp_path / "direct")
    assert got_l and all(got_l[s] == want_l[s] for s in got_l)
    assert got["metrics"]["loss"] == want["metrics"]["loss"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(got["state"]), tree_leaves(want["state"]), strict=True))
    assert np.isfinite(got["metrics"]["loss"])
