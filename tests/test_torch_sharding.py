"""The port's sharding rules (``distributed/sharding.py``'s token-LM half,
``training/optimizer.py`` ``state_specs``) against the reference's.

A rule is a pure function of a leaf's path, its shape and the mesh's axis
sizes, so every spec must equal the reference's exactly, as a tuple
(``tuple(P(...))``), leaf by leaf by path.  The port's trees are taken on
the ``meta`` device at full width; the reference's under
``jax.eval_shape``.  Meshes are stand-ins with the production sizes, as
the reference's own tests use (``tests/test_distributed.py:40-43``);
``launch/mesh.py`` ``Mesh`` over meta devices gives the same sizes.
The meta cache trees themselves (paths, shapes, dtypes):
``tests/test_torch_cache_specs.py``.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as j_configs
from repro.configs import rsnn_timit as j_timit
from repro.core import rsnn as j_rsnn
from repro.distributed import sharding as j_shd
from repro.launch import steps as j_steps
from repro.models import registry as j_registry
from repro.training import optimizer as j_opt
from repro_torch import configs
from repro_torch.configs import rsnn_timit
from repro_torch.core import rsnn
from repro_torch.core.tree import (PartitionSpec as P, tree_leaves,
                                   tree_leaves_with_path)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import registry
from repro_torch.training import optimizer as opt


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


POD = FakeMesh(data=16, model=16)
MULTIPOD = FakeMesh(pod=2, data=16, model=16)
SMALL = FakeMesh(data=4, model=2)  # the reference's 8-device test mesh
MESHES = {"pod": POD, "multipod": MULTIPOD, "small": SMALL}
ARCHS = registry.list_archs()
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")


def j_specs(tree) -> dict:
    """The reference's spec tree as {keystr path: tuple}."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def specs(tree) -> dict:
    """The port's spec tree as {path: tuple}; every leaf a ``P``."""
    out = {}
    for p, s in tree_leaves_with_path(tree):
        assert isinstance(s, P), (p, s)
        out[p] = tuple(s)
    return out


@functools.lru_cache(maxsize=None)
def j_params(arch: str):
    return jax.eval_shape(j_registry.get_model(arch).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def params(arch: str):
    return registry.get_model(arch).init(torch.Generator(), device="meta")


@pytest.fixture(autouse=True)
def no_registered_axes():
    """Each test starts and ends with no axes registered in either
    package (``set_activation_axes`` is module state)."""
    shd.set_activation_axes(None)
    j_shd.set_activation_axes(None)
    yield
    shd.set_activation_axes(None)
    j_shd.set_activation_axes(None)


# ------------------------------------------------------------ spec type


def test_partition_spec_is_a_tuple_leaf():
    assert tuple(P()) == tuple(PartitionSpec()) == ()
    assert tuple(P(None)) == tuple(PartitionSpec(None)) == (None,)
    entries = (("pod", "data"), None, "model")
    assert tuple(P(*entries)) == tuple(PartitionSpec(*entries)) == entries
    tree = {"a": P("data", None), "b": [P(), P(("pod", "data"))]}
    assert [s for _, s in tree_leaves_with_path(tree)] == \
        [P("data", None), P(), P(("pod", "data"))]
    import copy
    import pickle
    spec = P(("pod", "data"), None)
    assert copy.deepcopy(spec) == spec
    assert type(pickle.loads(pickle.dumps(spec))) is P


# ---------------------------------------------------- parameter specs


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch):
    """All ten archs at full width, on the production meshes and the
    reference's 4 x 2 test mesh."""
    for mesh in MESHES.values():
        assert specs(shd.tree_param_specs(params(arch), mesh)) == \
            j_specs(j_shd.tree_param_specs(j_params(arch), mesh))


@pytest.mark.parametrize("name", ["PRUNED", "BASELINE"])
def test_rsnn_param_specs_equal_reference(name):
    cfg, j_cfg = getattr(rsnn_timit, name), getattr(j_timit, name)
    tree = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    j_tree = jax.eval_shape(lambda k: j_rsnn.init_params(k, j_cfg),
                            jax.random.PRNGKey(0))
    for mesh in MESHES.values():
        got = specs(shd.tree_param_specs(tree, mesh))
        assert got == j_specs(j_shd.tree_param_specs(j_tree, mesh))
    # the recurrent and FC outputs shard over 'model' on the pod mesh
    assert specs(shd.tree_param_specs(tree, POD))["['fc_w']"][-1] == "model"


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_reference(arch):
    """The three optimizers' state specs for each arch, and the spec tree
    has the paths of ``init_opt_state``'s tree (so a state places leaf by
    leaf), each spec no longer than its leaf's rank."""
    p = params(arch)
    for name in OPTIMIZERS:
        ocfg = opt.OptimizerConfig(name=name)
        j_ocfg = j_opt.OptimizerConfig(name=name)
        state = dict(tree_leaves_with_path(opt.init_opt_state(p, ocfg)))
        for mesh in (POD, MULTIPOD):
            got = opt.state_specs(shd.tree_param_specs(p, mesh), p, ocfg)
            want = j_opt.state_specs(
                j_shd.tree_param_specs(j_params(arch), mesh),
                j_params(arch), j_ocfg)
            got = specs(got)
            assert got == j_specs(want), (arch, name)
            assert got.keys() == state.keys()
            assert all(len(s) <= state[k].dim() for k, s in got.items())


def test_state_specs_rules():
    """The reference's rules by hand: 8-bit ``{"q", "scale"}``, and
    Adafactor's factored rows and columns."""
    tree = {"w": torch.empty(256, 512, device="meta"),
            "n": torch.empty(64, 512, device="meta")}
    ps = {"w": P("data", "model"), "n": P(None, "model")}
    s8 = opt.state_specs(ps, tree, opt.OptimizerConfig(name="adamw8bit"))
    assert s8["m"]["w"] == {"q": P("data", "model"), "scale": P()}
    sf = opt.state_specs(ps, tree, opt.OptimizerConfig(name="adafactor"))
    assert sf["vr"] == {"w": P("data"), "n": P(None, "model")}
    assert sf["vc"] == {"w": P("model"), "n": P()}
    with pytest.raises(ValueError):
        opt.state_specs(ps, tree, opt.OptimizerConfig(name="sgd"))


# ------------------------------------------------------- batch specs


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch):
    cfg, j_cfg = registry.get_model(arch).cfg, j_registry.get_model(arch).cfg
    for shape, j_shape in zip(configs.LM_SHAPES, j_configs.LM_SHAPES,
                              strict=True):
        for mesh in MESHES.values():
            got = shd.batch_specs(steps.batch_shapes(cfg, shape), mesh)
            want = j_shd.batch_specs(j_steps.batch_shapes(j_cfg, j_shape),
                                     mesh)
            assert specs(got) == j_specs(want), (shape.name, mesh.shape)


# -------------------------------------------- the reference's own cases


def test_reference_param_spec_rules():
    """``tests/test_distributed.py:37-55``, on the port."""
    m = POD
    assert shd.param_spec("['layers']['attn']['w_q']", (26, 2304, 2048), m) \
        == P(None, "data", "model")
    assert shd.param_spec("['layers']['attn']['w_o']", (26, 2048, 2304), m) \
        == P(None, "model", "data")
    assert shd.param_spec("['layers']['moe']['w_gate']",
                          (58, 256, 7168, 2048), m) \
        == P(None, "model", "data", None)
    assert shd.param_spec("['embed']['tok']", (92672, 6144), m) == \
        P("model", "data")
    assert shd.param_spec("['layers']['attn']['w_q']", (26, 33, 17), m) \
        == P(None, None, None)
    assert shd.param_spec("['final_norm']['scale']", (2304,), m) == P(None)


def test_reference_cache_spec_rules():
    """``tests/test_distributed.py:58-69``, on the port."""
    s = shd.cache_spec("['layers'].k", (26, 128, 32768, 32, 128), POD,
                       batch=128)
    assert tuple(s)[1] == "data"
    s1 = shd.cache_spec(".k", (1, 524288, 4, 256), POD, batch=1)
    assert "data" in tuple(s1)


QUIRKS = [
    # cache_spec: the FIRST dim equal to the batch is the batch dim, here a
    # stacked layer axis of the same size
    ("cache", "['layers'].k", (16, 16, 64, 32, 8), 16),
    ("cache", ".layers.k", (32, 32, 1024, 4, 128), 32),
    # B = 1: context parallel, the longest dim over data, the next over
    # model
    ("cache", ".k", (1, 524288, 4, 256), 1),
    ("cache", ".m", (1, 8, 512), 1),
    # a batch that only 'data' divides on the multi-pod mesh
    ("cache", ".k", (48, 1024, 16, 64), 48),
    # _div also demands n >= the axis size: a zero-size dim stays whole
    ("param", "['layers']['attn']['w_q']", (2, 0, 32), None),
    ("param", "['embed']['tok']", (0, 64), None),
    ("param", "['layers']['mlp']['w_up']", (4, 8, 16), None),
    # replicated names still FSDP their 2-D leaves, col-parallel ones
    # also over model; router / dec_pos / conv_w stay whole
    ("param", "['layers']['mamba']['w_gates']", (4, 4096, 512), None),
    ("param", "['layers']['moe']['router']", (4, 4096, 64), None),
    ("param", "['dec_pos']", (32768, 512), None),
    # an unknown 2-D leaf FSDPs its bigger dim
    ("param", "['proj']['weird']", (64, 4096), None),
    ("param", "['proj']['weird']", (4096, 64), None),
    # expert leaves: w_down's FSDP dim is the last
    ("param", "['layers']['moe']['w_down']", (2, 64, 2048, 7168), None),
    ("param", ".lif0.raw_beta", (128,), None),
]


@pytest.mark.parametrize("kind,path,shape,batch", QUIRKS)
def test_quirk_cases_equal_reference(kind, path, shape, batch):
    for mesh in MESHES.values():
        if kind == "cache":
            assert tuple(shd.cache_spec(path, shape, mesh, batch)) == \
                tuple(j_shd.cache_spec(path, shape, mesh, batch))
        else:
            assert tuple(shd.param_spec(path, shape, mesh)) == \
                tuple(j_shd.param_spec(path, shape, mesh))


def test_cache_spec_takes_the_first_batch_sized_dim():
    s = shd.cache_spec("['layers'].k", (16, 16, 64, 32, 8), POD, batch=16)
    assert tuple(s) == ("data", None, None, "model", None)


# ------------------------------------------------- registered axes


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
def test_axis_helpers_equal_reference(mesh):
    m = MESHES[mesh]
    shd.set_activation_axes(m)
    j_shd.set_activation_axes(m)
    for axis in ("pod", "data", "model", "other"):
        assert shd.axis_size(axis) == j_shd.axis_size(axis)
        for n in (0, 1, 2, 4, 8, 16, 24, 32, 48, 64, 256, 512, 1000):
            assert shd.shardable(n, axis) == j_shd.shardable(n, axis)
    for n in (0, 1, 2, 4, 8, 16, 24, 32, 48, 64, 256, 512, 1000):
        assert shd._batch_axes(n) == j_shd._batch_axes(n), n
    shd.set_activation_axes(None)
    assert shd.axis_size("data") == 1 and shd._batch_axes(256) is None


def test_axis_helpers_read_a_mesh():
    """``launch/mesh.py`` meshes register the same sizes as the stand-ins."""
    m = mesh_lib.make_production_mesh(multi_pod=True,
                                      devices=["meta"] * 512)
    shd.set_activation_axes(m)
    assert [shd.axis_size(a) for a in ("pod", "data", "model")] == [2, 16, 16]
    assert shd._batch_axes(256) == ("pod", "data")
    assert shd._batch_axes(16) == "data"
    assert specs(shd.tree_param_specs(params("gemma2-2b"), m)) == \
        specs(shd.tree_param_specs(params("gemma2-2b"), MULTIPOD))


def test_constrain_hints_are_identities():
    """``tests/test_distributed.py:152-156``, and the port's hints return
    ``x`` itself with axes registered too (no partitioner to act on)."""
    x = torch.ones(4, 8)
    np.testing.assert_array_equal(shd.constrain_batch(x).numpy(), x.numpy())
    np.testing.assert_array_equal(shd.constrain_last_dim(x).numpy(),
                                  x.numpy())
    for m in (None, POD):
        shd.set_activation_axes(m)
        assert shd.constrain(x, P("data", None)) is x
        assert shd.constrain_batch(x, model_dim=1) is x
        assert shd.constrain_dim(x, 1, "model") is x
        assert shd.constrain_last_dim(x) is x
        assert shd.constrain_dims(x, {0: "batch", 1: "model"}) is x


def test_stream_shardings():
    """The stream specs and the mesh's devices along the axis: what
    ``shard_state`` takes."""
    state = rsnn.init_state(rsnn_timit.PRUNED, 8, device="cpu")
    m = mesh_lib.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    spec, devices = shd.stream_shardings(state, m)
    assert spec == shd.stream_state_specs(state)
    assert devices == [torch.device("cpu")] * 4
    parts = shd.shard_state(state, devices)
    assert len(parts) == 4
    assert parts[0].h0.shape == (state.h0.shape[0], 2, state.h0.shape[2])
    back = shd.gather_state(parts)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(state), strict=True))
