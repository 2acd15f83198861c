"""repro_torch's compression and packing (the write side) vs the reference's.

Seeded numpy inputs go through ``repro`` and ``repro_torch`` on the CPU.
Tolerances:

* bit for bit: ``quantize_to_int``, ``fake_quant``, ``pack_int4`` (on
  values that land on .5, rounded half to even in both), the magnitude and
  N:M masks (with ties, and N:M over a row count that is not a multiple of
  m), ``sparsify_columns``, ``pack_nm_groups``, every layout's
  ``pack``/``unpack``/``flatten``/``size_bytes``/``stored_entries``,
  ``pack_model`` over four recipes, ``packed_size_report`` (dict for
  dict), ``compressed_size_bytes``, ``TimitLikeStream.batch``, and an
  artifact written by the port read by the reference;
* row and channel masks take float32 L2 norms, whose sum order may move a
  norm by an ulp: the masks are equal except where a norm lies within
  4 ulp of the threshold (``_assert_norm_mask``);
* tests/test_torch_compression_engine.py holds, with this file's
  helpers, the in-process int4 engines, the seeded parameters and data,
  ``chip_smoke.py``'s artifacts and the example.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import importlib.util
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import layouts as j_layouts
from repro.core import lif as j_lif
from repro.core import rsnn as j_rsnn
from repro.core import sparse as j_sparse
from repro.core.compression import compress as j_compress
from repro.core.compression import pruning as j_pruning
from repro.core.compression import quantization as j_quant
from repro.core.layouts import csc as j_csc
from repro.core.layouts import nm as j_nm
from repro.serving import stream as S
from repro_torch.configs.rsnn_timit import PRUNED
from repro_torch.core import artifact, layouts, lif, rsnn, sparse
from repro_torch.core.compression import compress, pruning, quantization
from repro_torch.core.layouts import csc, nm
from repro_torch.serving import stream as TS
from test_torch_stream import ROOT

SMALL = {"input_dim": 8, "hidden_dim": 18, "fc_dim": 12, "num_ts": 2}
# the four recipes of the packing phase: name -> (fc_prune_frac,
# prune_specs as (tensor, "nm" | pruned fraction))
RECIPES = {
    "csc": (0.4, ()),
    "nm": (0.0, (("fc_w", "nm"),)),
    "mixed": (0.0, (("l0_wh", "nm"), ("fc_w", 0.4))),
    "dense": (0.0, ()),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _equal(got, want):
    """Bit-equal, dtype included."""
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _configs(recipe: str):
    """The recipe as (reference, port) CompressionConfigs."""
    frac, specs = RECIPES[recipe]

    def build(cc, ps):
        return cc(fc_prune_frac=frac, weight_bits=4, prune_specs=tuple(
            (name, ps(kind="nm", n=2, m=4) if s == "nm" else ps(frac=s))
            for name, s in specs))

    return (build(j_compress.CompressionConfig, j_compress.PruneSpec),
            build(compress.CompressionConfig, compress.PruneSpec))


def _params(dims: dict, seed: int = 0):
    """Seeded numpy weights uniform in +-1/sqrt(fan_in) and LIF parameters
    at init_lif's values, as (reference params, port params, cfgs)."""
    cfg_t = rsnn.RSNNConfig(**dims)
    cfg_j = j_rsnn.RSNNConfig(**dims)
    rng = np.random.default_rng(seed)
    flat = {n: (rng.uniform(-1, 1, s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in cfg_t.layer_shapes.items()}
    pj = {n: jnp.asarray(v) for n, v in flat.items()}
    pt = {n: _t(v) for n, v in flat.items()}
    for i in (0, 1):
        jl = j_lif.init_lif(cfg_t.hidden_dim)
        pj[f"lif{i}"] = jl
        pt[f"lif{i}"] = lif.LIFParams(*(_t(np.asarray(a)) for a in jl))
    return pj, pt, cfg_j, cfg_t


def _flat(t) -> tuple[str, dict]:
    """(layout tag, flattened fields) of a port or a reference tensor."""
    try:
        layout = layouts.layout_of(t)
    except TypeError:
        layout = j_layouts.layout_of(t)
    return layout.name, layout.flatten(t)


def _assert_layout_tensor_equal(got, want):
    (tag_a, a), (tag_b, b) = _flat(got), _flat(want)
    assert tag_a == tag_b
    assert a.keys() == b.keys()
    for field in a:
        _equal(a[field], b[field])


def _assert_packed_equal(got: sparse.PackedRSNN, want):
    assert list(got.quant) == list(want.quant)
    for name, qt in want.quant.items():
        _equal(got.quant[name].packed, qt.packed)
        _equal(got.quant[name].scale, qt.scale)
    assert list(got.sparse) == list(want.sparse)
    for name, t in want.sparse.items():
        _assert_layout_tensor_equal(got.sparse[name], t)
    assert list(got.lif) == list(want.lif)
    for name, v in want.lif.items():
        _equal(got.lif[name], v)


# ----------------------------------------------------------- quantization


def _halves(rng) -> np.ndarray:
    """(16, 6) weights whose column max is 7 (scale 1.0 at 4 bits) and
    whose other entries are k + 0.5: every w / scale lands on .5."""
    w = (rng.integers(-7, 7, (16, 6)) + 0.5).astype(np.float32)
    w[0] = 7.0
    return w


@pytest.mark.parametrize("data", ["halves", "normal"])
@pytest.mark.parametrize("granularity", ["per_channel", "per_tensor"])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_and_pack_bit_equal(data, granularity, bits):
    rng = np.random.default_rng(1)
    w = _halves(rng) if data == "halves" else \
        rng.normal(size=(16, 6)).astype(np.float32)
    js = j_quant.QuantSpec(bits=bits, granularity=granularity)
    ts = quantization.QuantSpec(bits=bits, granularity=granularity)
    qj, sj = j_quant.quantize_to_int(jnp.asarray(w), js)
    qt, st = quantization.quantize_to_int(_t(w), ts)
    _equal(qt, qj)
    _equal(st, sj)
    _equal(quantization.fake_quant(_t(w), ts),
           j_quant.fake_quant(jnp.asarray(w), js))
    if data == "halves" and bits == 4:
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0
        np.testing.assert_array_equal(qt.numpy()[1:],
                                      np.round(w[1:]).astype(np.int8))
    if bits == 4:
        packed = quantization.pack_int4(qt)
        _equal(packed, j_quant.pack_int4(qj))
        _equal(quantization.unpack_int4(packed), qt)
    names = ("a", "b")
    tree_t = quantization.quantize_tree({"a": _t(w), "b": _t(-w), "c": 1},
                                        ts, names)
    tree_j = j_quant.quantize_tree({"a": jnp.asarray(w), "b": jnp.asarray(-w),
                                    "c": 1}, js, names)
    assert tree_t["c"] == 1
    for n in names:
        _equal(tree_t[n], tree_j[n])


def test_fake_quant_passes_the_gradient_straight_through():
    w = _t(np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32))
    w.requires_grad_(True)
    quantization.fake_quant(w).mul(torch.arange(4.0)).sum().backward()
    torch.testing.assert_close(w.grad, torch.arange(4.0).expand(8, 4),
                               rtol=0, atol=0)


def test_pack_int4_refuses_an_odd_row_count():
    with pytest.raises(ValueError, match="row pairs"):
        quantization.pack_int4(torch.zeros((3, 2), dtype=torch.int8))


# ------------------------------------------------------------------ masks


def _tied(rng, shape) -> np.ndarray:
    """Weights from 7 values: many ties of |w| inside groups and across
    the threshold."""
    return (rng.integers(-3, 4, shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("data", ["tied", "normal"])
@pytest.mark.parametrize("frac", [0.0, 0.4, 0.75])
def test_magnitude_mask_bit_equal(data, frac):
    rng = np.random.default_rng(3)
    w = _tied(rng, (18, 7)) if data == "tied" else \
        rng.normal(size=(18, 7)).astype(np.float32)
    got = pruning.magnitude_prune_mask(_t(w), frac)
    _equal(got, j_pruning.magnitude_prune_mask(jnp.asarray(w), frac))
    if data == "tied" and frac > 0:  # ties at the threshold are all kept
        assert float(got.sum()) >= round(w.size * (1 - frac))


@pytest.mark.parametrize("data", ["tied", "normal"])
@pytest.mark.parametrize("rows", [16, 18, 3])
@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (3, 8), (4, 4)])
def test_nm_mask_bit_equal(data, rows, n, m):
    """Ties keep row order (stable ranks), and a tail group of r < m rows
    keeps min(n, r): its -inf pads never outrank a real weight."""
    rng = np.random.default_rng(4)
    w = _tied(rng, (rows, 5)) if data == "tied" else \
        rng.normal(size=(rows, 5)).astype(np.float32)
    got = pruning.nm_prune_mask(_t(w), n, m)
    _equal(got, j_pruning.nm_prune_mask(jnp.asarray(w), n, m))
    tail = rows % m
    if tail:
        np.testing.assert_array_equal(got.numpy()[rows - tail:].sum(axis=0),
                                      min(n, tail))


def _assert_norm_mask(got, want, w, axis: int, frac: float):
    """Equal, except where a norm lies within 4 ulp of the threshold."""
    got, want = got.numpy(), np.asarray(want)
    if frac <= 0:
        np.testing.assert_array_equal(got, want)
        return
    norms = np.sqrt((w.astype(np.float64) ** 2).sum(axis=axis))
    k = max(int(round(norms.size * (1.0 - frac))), 1)
    thresh = np.sort(norms)[-k]
    near = np.abs(norms - thresh) <= 4 * np.spacing(np.float32(thresh))
    differs = (got != want).any(axis=axis)
    assert not (differs & ~near).any()


@pytest.mark.parametrize("data", ["tied_rows", "normal"])
@pytest.mark.parametrize("frac", [0.0, 0.3, 0.5])
def test_row_and_channel_masks_within_4_ulp(data, frac):
    rng = np.random.default_rng(5)
    w = rng.normal(size=(12, 10)).astype(np.float32)
    if data == "tied_rows":  # equal norms in both frameworks
        w[1], w[7] = w[4], -w[4]
        w[:, 3] = w[:, 6]
    for axis, fn, jfn in ((1, pruning.row_prune_mask,
                           j_pruning.row_prune_mask),
                          (0, pruning.channel_prune_mask,
                           j_pruning.channel_prune_mask)):
        got = fn(_t(w), frac)
        assert got.shape == w.shape and got.dtype == torch.float32
        _assert_norm_mask(got, jfn(jnp.asarray(w), frac), w, axis, frac)


def test_build_mask_dispatch_and_helpers():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(16, 6)).astype(np.float32)
    specs = [("magnitude", 0.3), ("nm", 0.0), ("row", 0.25),
             ("channel", 0.5)]
    masks_t, masks_j = {}, {}
    for kind, frac in specs:
        masks_t[kind] = pruning.build_mask(
            _t(w), compress.PruneSpec(kind=kind, frac=frac))
        masks_j[kind] = j_pruning.build_mask(
            jnp.asarray(w), j_compress.PruneSpec(kind=kind, frac=frac))
        _equal(masks_t[kind], masks_j[kind])
    assert pruning.sparsity_of(masks_t) == j_pruning.sparsity_of(masks_j)
    out = pruning.apply_masks({"magnitude": _t(w), "x": 3},
                              {"magnitude": masks_t["magnitude"]})
    _equal(out["magnitude"], _t(w) * masks_t["magnitude"])
    assert out["x"] == 3
    with pytest.raises(ValueError, match="unknown prune kind"):
        pruning.build_mask(_t(w), types.SimpleNamespace(kind="x"))
    cfg = pruning.structured_prune_config(rsnn.RSNNConfig(), 128)
    assert cfg == PRUNED


@pytest.mark.parametrize("kw", [
    {"kind": "x"}, {"frac": 1.0}, {"frac": -0.1},
    {"kind": "nm", "n": 0}, {"kind": "nm", "n": 5, "m": 4},
    {"layout": "nope"}, {"layout": "dense"},
    {"kind": "magnitude", "frac": 0.4, "layout": "nm_group"},
    {"kind": "nm", "n": 2, "m": 32, "layout": "nm_group"}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_prune_spec_raises_where_reference_raises(kw):
    with pytest.raises(ValueError) as want:
        j_compress.PruneSpec(**kw)
    with pytest.raises(ValueError) as got:
        compress.PruneSpec(**kw)
    assert str(got.value) == str(want.value).replace(
        "('auto', 'csc', 'dense', 'nm_group')",
        str(("auto",) + layouts.available_layouts()))


@pytest.mark.parametrize("recipe", RECIPES)
def test_compression_config_resolution_equals_reference(recipe):
    cj, ct = _configs(recipe)
    assert ct.fc_prune_fraction == cj.fc_prune_fraction
    assert {n: dataclasses.asdict(s)
            for n, s in ct.resolved_prune_specs.items()} == \
        {n: dataclasses.asdict(s) for n, s in cj.resolved_prune_specs.items()}
    assert dataclasses.asdict(ct.quant_spec) == \
        dataclasses.asdict(cj.quant_spec)
    assert compress.CompressionConfig().quant_spec is None
    with pytest.raises(ValueError, match="absent from the model"):
        compress.init_compression({}, compress.CompressionConfig(
            fc_prune_frac=0.4))


# ---------------------------------------------------------------- layouts


@pytest.mark.parametrize("keep_kind", ["mask", "none", "empty_column"])
def test_sparsify_columns_and_csc_layout_bit_equal(keep_kind):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(18, 9)).astype(np.float32)
    q, scale = (np.asarray(a) for a in j_quant.quantize_to_int(
        jnp.asarray(w)))
    keep = rng.random(w.shape) >= 0.6
    if keep_kind == "empty_column":
        keep[:, 2] = False
    q = np.where(keep, q, 0).astype(np.int8)
    k = None if keep_kind == "none" else keep
    got = csc.sparsify_columns(_t(q), _t(scale),
                               None if k is None else _t(k))
    want = j_csc.sparsify_columns(q, scale, keep=k)
    for a, b in zip(got, want):
        _equal(a, b)
    layout, j_layout = layouts.get_layout("csc"), j_layouts.get_layout("csc")
    got_p = layout.pack(_t(q), _t(scale), keep=_t(keep.astype(np.float32)))
    want_p = j_layout.pack(q, scale, keep=keep.astype(np.float32))
    _assert_layout_tensor_equal(got_p, want_p)
    _equal(layout.unpack(got_p, 18), j_layout.unpack(want_p, 18))
    for bits in (4, 8):
        assert layout.size_bytes(got_p, 18, bits) == \
            j_layout.size_bytes(want_p, 18, bits)
    assert layout.stored_entries(got_p) == j_layout.stored_entries(want_p)
    assert csc.csc_stored_entries(got._replace(count=None)) == \
        j_csc.csc_stored_entries(want._replace(count=None))


@pytest.mark.parametrize("rows", [16, 18, 126])
@pytest.mark.parametrize("n,m", [(1, 4), (2, 4), (3, 8), (2, 16)])
def test_pack_nm_groups_and_nm_layout_bit_equal(rows, n, m):
    rng = np.random.default_rng(8)
    w = rng.normal(size=(rows, 7)).astype(np.float32)
    q, scale = (np.asarray(a) for a in j_quant.quantize_to_int(
        jnp.asarray(w)))
    keep = np.asarray(j_pruning.nm_prune_mask(jnp.asarray(w), n, m))
    q = np.where(keep > 0, q, 0).astype(np.int8)
    spec_t = compress.PruneSpec(kind="nm", n=n, m=m)
    spec_j = j_compress.PruneSpec(kind="nm", n=n, m=m)
    layout, j_layout = (lib.get_layout("nm_group")
                        for lib in (layouts, j_layouts))
    got = layout.pack(_t(q), _t(scale), keep=_t(keep), spec=spec_t)
    want = j_layout.pack(q, scale, keep=keep, spec=spec_j)
    _assert_layout_tensor_equal(got, want)
    assert (got.n, got.m, got.rows) == (want.n, want.m, want.rows)
    _equal(layout.unpack(got, rows), j_layout.unpack(want, rows))
    assert layout.size_bytes(got, rows) == j_layout.size_bytes(want, rows)
    assert layout.stored_entries(got) == j_layout.stored_entries(want)
    # N:M and CSC of one mask hold the same matrix
    _equal(layout.unpack(got, rows), layouts.get_layout("csc").unpack(
        csc.sparsify_columns(_t(q), _t(scale), _t(keep)), rows))


@pytest.mark.parametrize("case", ["m_over_16", "n_over_m", "n_zero",
                                  "irregular"])
def test_pack_nm_groups_refusals_match_reference(case):
    q = np.ones((8, 3), np.int8)
    scale = np.ones((1, 3), np.float32)
    keep = np.zeros((8, 3), bool)
    keep[:2] = True
    n, m = {"m_over_16": (2, 32), "n_over_m": (5, 4), "n_zero": (0, 4),
            "irregular": (1, 4)}[case]
    with pytest.raises(ValueError) as want:
        j_nm.pack_nm_groups(q, scale, keep, n, m)
    with pytest.raises(ValueError) as got:
        nm.pack_nm_groups(_t(q), _t(scale), _t(keep), n, m)
    assert str(got.value) == str(want.value)
    layout = layouts.get_layout("nm_group")
    with pytest.raises(ValueError, match="keep= is required"):
        layout.pack(_t(q), _t(scale))
    with pytest.raises(ValueError, match="PruneSpec of kind 'nm'"):
        layout.pack(_t(q), _t(scale), keep=_t(keep),
                    spec=compress.PruneSpec(frac=0.5))


def test_dense_layout_bit_equal():
    rng = np.random.default_rng(9)
    w = rng.normal(size=(18, 5)).astype(np.float32)
    q, scale = (np.asarray(a) for a in j_quant.quantize_to_int(
        jnp.asarray(w)))
    layout, j_layout = (lib.get_layout("dense")
                        for lib in (layouts, j_layouts))
    got, want = layout.pack(_t(q), _t(scale)), j_layout.pack(q, scale)
    _assert_layout_tensor_equal(got, want)
    _equal(layout.unpack(got, 18), j_layout.unpack(want, 18))
    assert layout.size_bytes(got, 18) == j_layout.size_bytes(want, 18)
    assert layout.stored_entries(got) == j_layout.stored_entries(want)


@pytest.mark.parametrize("spec", [None, "magnitude", "nm", "nm_csc",
                                  "nm_m32"])
def test_resolve_for_spec_equals_reference(spec):
    def make(ps):
        return {None: None, "magnitude": ps(frac=0.4),
                "nm": ps(kind="nm"), "nm_csc": ps(kind="nm", layout="csc"),
                "nm_m32": ps(kind="nm", n=2, m=32)}[spec]

    assert layouts.resolve_for_spec(make(compress.PruneSpec)).name == \
        j_layouts.resolve_for_spec(make(j_compress.PruneSpec)).name



@pytest.mark.parametrize("lib", [layouts, j_layouts],
                         ids=["port", "reference"])
def test_register_and_unregister_plugin(lib):
    """A test-local plugin layout comes and goes, as
    ``tests/test_layouts.py`` holds it on the reference; removing a name
    that is not registered is a no-op in both packages."""
    class PluginTensor(tuple):
        pass

    class Plugin(lib.csc.SparseColumnsLayout):
        name = "plugin_csc"
        tensor_type = PluginTensor

    before = lib.available_layouts()
    lib.register_layout(Plugin())
    try:
        assert "plugin_csc" in lib.available_layouts()
        assert lib.get_layout("plugin_csc").name == "plugin_csc"
    finally:
        lib.unregister_layout("plugin_csc")
    assert lib.available_layouts() == before
    lib.unregister_layout("plugin_csc")
    lib.unregister_layout("no_such_layout")
    assert lib.available_layouts() == before
    with pytest.raises(ValueError, match="unknown weight layout"):
        lib.get_layout("plugin_csc")


# ------------------------------------------------------------ pack_model


@pytest.mark.parametrize("recipe", RECIPES)
def test_pack_model_bit_equal_over_recipes(recipe):
    """Every array, the size report dict for dict, and the float side's
    ``compressed_size_bytes`` equal to its ``broadcast_total_bytes``."""
    pj, pt, cfg_j, cfg_t = _params(SMALL)
    cj, ct = _configs(recipe)
    sj, st = j_compress.init_compression(pj, cj), \
        compress.init_compression(pt, ct)
    assert list(st.masks) == list(sj.masks)
    for name in sj.masks:
        _equal(st.masks[name], sj.masks[name])
    got = sparse.pack_model(pt, cfg_t, ct, st)
    want = j_sparse.pack_model(pj, cfg_j, cj, sj)
    _assert_packed_equal(got, want)
    _assert_packed_equal(compress.pack_for_inference(pt, cfg_t, ct, st),
                         want)
    report = sparse.packed_size_report(got)
    assert report == j_sparse.packed_size_report(want)
    size = compress.compressed_size_bytes(pt, ct, st)
    assert size == j_compress.compressed_size_bytes(pj, cj, sj)
    assert size == report["broadcast_total_bytes"]
    for name, qt in got.quant.items():
        assert sparse.quant_size_bytes(qt) == \
            j_sparse.quant_size_bytes(want.quant[name])
    # the packed model dequantizes to the materializer's weights
    mat = compress.materializer(ct, st)(pt)
    for name, qt in got.quant.items():
        _equal(sparse.dequantize(qt), mat[name])


def test_pruned_model_is_100864_bytes():
    """PRUNED with the FC pruned 40%: (5,120 + 3 x 16,384 + 147,456)
    entries at 4 bits, from either side of the accounting."""
    dims = {f.name: getattr(PRUNED, f.name) for f in
            dataclasses.fields(PRUNED) if f.name in SMALL}
    pj, pt, cfg_j, cfg_t = _params(dims)
    cj, ct = _configs("csc")
    st = compress.init_compression(pt, ct)
    report = sparse.packed_size_report(sparse.pack_model(pt, cfg_t, ct, st))
    assert report["broadcast_total_bytes"] == 100_864.0 == \
        compress.compressed_size_bytes(pt, ct, st)
    sj = j_compress.init_compression(pj, cj)
    assert report == j_sparse.packed_size_report(
        j_sparse.pack_model(pj, cfg_j, cj, sj))


def test_pack_model_refusals():
    _, pt, _, cfg_t = _params(SMALL)
    st = compress.CompressionState(masks={})
    with pytest.raises(ValueError, match="weight_bits"):
        sparse.pack_model(pt, cfg_t, compress.CompressionConfig(), st)
    with pytest.raises(ValueError, match="nibble-int4"):
        sparse.pack_model(pt, cfg_t, compress.CompressionConfig(
            weight_bits=8), st)


# ------------------------------------------------------------- artifacts


def _save_both(tmp_path, recipe):
    pj, pt, cfg_j, cfg_t = _params(SMALL)
    cj, ct = _configs(recipe)
    packed = sparse.pack_model(pt, cfg_t, ct,
                               compress.init_compression(pt, ct))
    x = np.random.default_rng(3).normal(size=(20, 8)).astype(np.float32)
    scale = TS.calibrate_input_scale(_t(x), 8)
    sparse_fc = "fc_w" in packed.sparse
    path = artifact.save_artifact(tmp_path / recipe, cfg=cfg_t,
                                  packed=packed, ccfg=ct, input_scale=scale,
                                  backend="pallas", sparse_fc=sparse_fc)
    want = j_artifact.save_artifact(
        tmp_path / f"{recipe}_ref", cfg=cfg_j,
        packed=j_sparse.pack_model(pj, cfg_j, cj,
                                   j_compress.init_compression(pj, cj)),
        ccfg=cj, input_scale=S.calibrate_input_scale(jnp.asarray(x), 8),
        backend="pallas", sparse_fc=sparse_fc)
    return path, want, packed


@pytest.mark.parametrize("recipe", RECIPES)
def test_port_artifact_loads_in_reference(tmp_path, recipe):
    """The port's ``save_artifact`` writes what the reference's writes:
    the same manifest and the same arrays, and the reference's
    ``load_artifact`` reads it with equal tensors."""
    path, ref_path, packed = _save_both(tmp_path, recipe)
    assert not list(path.glob("*.tmp"))
    got, want = (json.loads((p / "manifest.json").read_text())
                 for p in (path, ref_path))
    assert got == want
    with np.load(path / "tensors.npz") as a, \
            np.load(ref_path / "tensors.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            _equal(a[key], b[key])
    ref = j_artifact.load_artifact(path)
    assert ref.precision == "int4" and ref.ccfg == j_artifact.load_artifact(
        ref_path).ccfg
    _assert_packed_equal(packed, ref.packed)
    port = artifact.load_artifact(path)  # and the port's own round trip
    _assert_packed_equal(port.packed, ref.packed)
    assert port.ccfg == _configs(recipe)[1]
    assert port.fc_prune_fraction == ref.ccfg.fc_prune_fraction



@pytest.mark.parametrize("recipe", RECIPES)
def test_size_report_equals_reference(tmp_path, recipe):
    """``RSNNArtifact.size_report`` reads the manifest's report as the
    reference's property does, on an artifact written by each package."""
    path, ref_path, packed = _save_both(tmp_path, recipe)
    for p in (path, ref_path):
        got = artifact.load_artifact(p).size_report
        assert got == j_artifact.load_artifact(p).size_report
        assert got == json.loads((p / "manifest.json").read_text())[
            "size_report"]
        assert got == sparse.packed_size_report(packed)
    mf = path / "manifest.json"
    m = json.loads(mf.read_text())
    del m["size_report"]
    mf.write_text(json.dumps(m))
    assert artifact.load_artifact(path).size_report is None
    assert j_artifact.load_artifact(path).size_report is None


def test_port_float_artifact_loads_in_reference(tmp_path):
    _, pt, cfg_j, cfg_t = _params(SMALL)
    path = artifact.save_artifact(tmp_path / "float", cfg=cfg_t, params=pt,
                                  input_scale=0.25, backend="fused")
    ref = j_artifact.load_artifact(path)
    assert ref.precision == "float" and ref.cfg == cfg_j
    for name in cfg_t.layer_shapes:
        _equal(pt[name], ref.params[name])
    for i in (0, 1):
        for a, b in zip(pt[f"lif{i}"], ref.params[f"lif{i}"]):
            _equal(a, b)
    _equal(np.float32(0.25), np.asarray(ref.input_scale))
    port = artifact.load_artifact(path)
    assert port.ccfg is None and port.fc_prune_fraction == 0.0
    for name in cfg_t.layer_shapes:
        _equal(port.params[name], pt[name])


def test_save_artifact_writes_the_manifest_last(tmp_path, monkeypatch):
    """A save that dies while writing the tensors leaves no manifest (an
    earlier one is removed first), which ``load_artifact`` rejects."""
    path, _, packed = _save_both(tmp_path, "csc")
    ccfg = _configs("csc")[1]

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(artifact.np, "savez", fail)
    with pytest.raises(OSError, match="disk full"):
        artifact.save_artifact(path, cfg=rsnn.RSNNConfig(**SMALL),
                               packed=packed, ccfg=ccfg)
    assert not (path / "manifest.json").exists()
    with pytest.raises(artifact.ArtifactError, match="missing"):
        artifact.load_artifact(path)
    with pytest.raises(ValueError, match="exactly one"):
        artifact.save_artifact(path, cfg=rsnn.RSNNConfig(**SMALL))
    with pytest.raises(ValueError, match="CompressionConfig"):
        artifact.save_artifact(path, cfg=rsnn.RSNNConfig(**SMALL),
                               packed=packed)
    with pytest.raises(ValueError, match="sparse_fc"):
        artifact.save_artifact(path, cfg=rsnn.RSNNConfig(**SMALL),
                               packed=packed._replace(sparse={}), ccfg=ccfg,
                               sparse_fc=True)


# ------------------------------------------------------------ chip_smoke


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
