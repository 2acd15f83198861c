"""The token-LM caches on the ``meta`` device and their sharding specs
against the reference's.

``init_cache(..., device="meta")`` of every arch must give the tree of
``jax.eval_shape(api.init_cache(B, S))``: the same paths, shapes and
dtypes, at the three cache-bearing shapes of ``LM_SHAPES`` (prefill_32k,
decode_32k, long_500k), allocating nothing; and ``tree_cache_specs`` on
those trees must equal the reference's as tuples, leaf by leaf, on the
production meshes.  Exact equality: shapes and rules are integers.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as j_configs
from repro.distributed import sharding as j_shd
from repro.models import registry as j_registry
from repro_torch import configs
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.distributed import sharding as shd
from repro_torch.models import registry

ARCHS = registry.list_archs()
CACHE_SHAPES = [s.name for s in configs.LM_SHAPES if s.kind != "train"]


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


MESHES = (FakeMesh(data=16, model=16), FakeMesh(pod=2, data=16, model=16),
          FakeMesh(data=4, model=2))


def shapes(shape_name: str) -> tuple:
    port = configs.shape_by_name(shape_name)
    ref = j_configs.shape_by_name(shape_name)
    assert (port.global_batch, port.seq_len) == (ref.global_batch, ref.seq_len)
    return port.global_batch, port.seq_len


def j_cache(arch: str, b: int, s: int):
    api = j_registry.get_model(arch)
    return jax.eval_shape(lambda: api.init_cache(b, s))


def test_cache_shapes_are_the_three_cache_bearing_ones():
    assert CACHE_SHAPES == ["prefill_32k", "decode_32k", "long_500k"]


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_cache_equals_reference_eval_shape(arch):
    for name in CACHE_SHAPES:
        b, s = shapes(name)
        got = registry.get_model(arch).init_cache(b, s, device="meta")
        want = jax.tree_util.tree_flatten_with_path(j_cache(arch, b, s))[0]
        want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in want}
        leaves = tree_leaves_with_path(got)
        assert all(t.device.type == "meta" for _, t in leaves)
        assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for p, t in leaves} == want, (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    for name in CACHE_SHAPES:
        b, s = shapes(name)
        got = registry.get_model(arch).init_cache(b, s, device="meta")
        j_tree = j_cache(arch, b, s)
        for mesh in MESHES:
            got_specs = {p: tuple(x) for p, x in tree_leaves_with_path(
                shd.tree_cache_specs(got, mesh, b))}
            flat = jax.tree_util.tree_flatten_with_path(
                j_shd.tree_cache_specs(j_tree, mesh, b),
                is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
            assert got_specs == {jax.tree_util.keystr(p): tuple(x)
                                 for p, x in flat}, (arch, name, mesh.shape)


def test_meta_is_taken_by_the_cache_initialisers_only():
    """``meta`` reaches the allocating functions; an entry point that runs
    still takes ``cuda`` or ``cpu`` alone."""
    from repro_torch.core.device import resolve_alloc_device, resolve_device

    assert resolve_alloc_device("meta") == torch.device("meta")
    assert resolve_alloc_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_alloc_device("cuda")
    cache = registry.get_model("zamba2-7b").init_cache(2, 8, device="cpu")
    assert all(t.device.type == "cpu" for _, t in tree_leaves_with_path(cache))
