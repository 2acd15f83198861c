"""repro_torch's artifact reader vs the reference's.

Artifacts are written by the reference's ``save_artifact`` (dense, CSC and
N:M-group payloads, mixed-level pruning, schema v2 and a rewritten v1) and
read by both readers; every array must be equal bit for bit.  A float
payload loads as the reference reads it; broken artifacts raise.  The
artifacts ``chip_smoke.py`` writes with numpy load in the reference reader
as well as the port's.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import rsnn, sparse
from repro.core.compression import (CompressionConfig, PruneSpec,
                                    init_compression, pruning)
from repro.serving import stream as S
from repro_torch.core import artifact
from repro_torch.core.layouts.csc import SparseColumns
from repro_torch.core.layouts.nm import NMGroupPacked

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(tmp_path, cfg, rng_key, ccfg, name="art"):
    params = rsnn.init_params(rng_key, cfg)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, cfg.input_dim)), jnp.float32)
    scale = S.calibrate_input_scale(x, cfg.input_bits)
    packed = sparse.pack_model(params, cfg, ccfg,
                               init_compression(params, ccfg))
    return j_artifact.save_artifact(tmp_path / name, cfg=cfg, packed=packed,
                                    ccfg=ccfg, input_scale=scale,
                                    backend="pallas", sparse_fc=bool(
                                        ccfg.fc_prune_frac))


def _assert_same(port, ref):
    """Every array of the port's load equals the reference's, bit for bit."""
    assert port.precision == ref.precision == "int4"
    assert port.backend == ref.backend
    assert port.sparse_fc == ref.sparse_fc
    assert port.layouts == ref.layouts
    for field in ("input_dim", "hidden_dim", "fc_dim", "num_ts",
                  "merged_spike", "input_bits", "hw_rounded_lif"):
        assert getattr(port.cfg, field) == getattr(ref.cfg, field)
    np.testing.assert_array_equal(port.input_scale.numpy(),
                                  np.asarray(ref.input_scale))
    assert port.packed.quant.keys() == ref.packed.quant.keys()
    for name, qt in ref.packed.quant.items():
        for a, b in zip(port.packed.quant[name], qt):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.packed.sparse.keys() == ref.packed.sparse.keys()
    for name, t in ref.packed.sparse.items():
        got = port.packed.sparse[name]
        if port.layouts[name] == "nm_group":
            assert isinstance(got, NMGroupPacked)
            assert (got.n, got.m, got.rows) == (t.n, t.m, t.rows)
            pairs = [(getattr(got, f), getattr(t, f))
                     for f in ("packed", "scale", "count")]
        else:
            assert isinstance(got, SparseColumns)
            pairs = zip(got, t)
        for a, b in pairs:
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert port.packed.lif.keys() == ref.packed.lif.keys()
    for name, v in ref.packed.lif.items():
        np.testing.assert_array_equal(port.packed.lif[name].numpy(),
                                      np.asarray(v))


@pytest.mark.parametrize("prune", [0.0, 0.4], ids=["dense", "csc"])
def test_load_artifact_equals_reference(tmp_path, small_cfg, rng_key, prune):
    ccfg = CompressionConfig(fc_prune_frac=prune, weight_bits=4)
    path = _write(tmp_path, small_cfg, rng_key, ccfg)
    _assert_same(artifact.load_artifact(path), j_artifact.load_artifact(path))


def test_packed_from_arrays_reads_reference_flatten(small_cfg, rng_key):
    """The weights-carried-across function on the reference's flat dict."""
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    params = rsnn.init_params(rng_key, small_cfg)
    packed = sparse.pack_model(params, small_cfg, ccfg,
                               init_compression(params, ccfg))
    flat, tags = j_artifact._flatten_packed(packed)
    got = artifact.packed_from_arrays(flat)
    assert tags == {"fc_w": "csc"}
    for name, qt in packed.quant.items():
        np.testing.assert_array_equal(got.quant[name].packed.numpy(),
                                      np.asarray(qt.packed))
        np.testing.assert_array_equal(got.quant[name].scale.numpy(),
                                      np.asarray(qt.scale))
    for a, b in zip(got.sparse["fc_w"], packed.sparse["fc_w"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_v1_artifact_loads_as_implicit_csc(tmp_path, small_cfg, rng_key):
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    path = _write(tmp_path, small_cfg, rng_key, ccfg)
    mf = path / artifact.MANIFEST
    m = json.loads(mf.read_text())
    m["schema_version"] = 1
    del m["layouts"]
    del m["sparse_fc"]
    mf.write_text(json.dumps(m))
    port = artifact.load_artifact(path)
    assert port.manifest["schema_version"] == 1
    assert port.layouts == {"fc_w": "csc"} and port.sparse_fc is False
    _assert_same(port, j_artifact.load_artifact(path))


@pytest.mark.parametrize("found", [0, 3, "2"])
def test_rejects_unsupported_schema_version(tmp_path, small_cfg, rng_key,
                                            found):
    path = _write(tmp_path, small_cfg, rng_key,
                  CompressionConfig(fc_prune_frac=0.4, weight_bits=4))
    mf = path / artifact.MANIFEST
    m = json.loads(mf.read_text())
    m["schema_version"] = found
    mf.write_text(json.dumps(m))
    with pytest.raises(artifact.ArtifactError, match="schema version"):
        artifact.load_artifact(path)


def test_rejects_missing_tensor_shape_mismatch_and_tag_mismatch(
        tmp_path, small_cfg, rng_key):
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    path = _write(tmp_path, small_cfg, rng_key, ccfg)
    mf = path / artifact.MANIFEST
    good = json.loads(mf.read_text())

    m = json.loads(json.dumps(good))
    m["tensors"]["quant.extra.packed"] = {"shape": [1], "dtype": "int8"}
    mf.write_text(json.dumps(m))
    with pytest.raises(artifact.ArtifactError, match="missing"):
        artifact.load_artifact(path)

    m = json.loads(json.dumps(good))
    m["tensors"]["quant.fc_w.packed"]["shape"][0] += 1
    mf.write_text(json.dumps(m))
    with pytest.raises(artifact.ArtifactError, match="manifest declares"):
        artifact.load_artifact(path)

    m = json.loads(json.dumps(good))
    m["layouts"] = {"fc_w": "dense"}
    mf.write_text(json.dumps(m))
    with pytest.raises(artifact.ArtifactError, match="layout tags"):
        artifact.load_artifact(path)

    mf.unlink()
    with pytest.raises(artifact.ArtifactError, match="missing"):
        artifact.load_artifact(path)


@pytest.mark.parametrize("pruned", [("fc_w",), ("l0_wh", "fc_w")],
                         ids=["fc", "mixed"])
def test_nm_group_artifact_loads_equal_to_reference(tmp_path, small_cfg,
                                                     rng_key, pruned):
    """An N:M-group payload loads, for the FC alone and under mixed-level
    pruning (a recurrent tensor 2:4 as well), with every array equal to
    the reference reader's."""
    nm = CompressionConfig(weight_bits=4, prune_specs=tuple(
        (name, PruneSpec(kind="nm", n=2, m=4)) for name in pruned))
    path = _write(tmp_path, small_cfg, rng_key, nm)
    port, ref = artifact.load_artifact(path), j_artifact.load_artifact(path)
    assert port.layouts == dict.fromkeys(pruned, "nm_group")
    assert port.fc_prune_fraction == ref.ccfg.fc_prune_fraction == 0.5
    _assert_same(port, ref)


def test_unported_payloads_raise(tmp_path, small_cfg, rng_key):
    """A float payload written by the reference's ``save_artifact(params=
    ...)`` loads: config, input scale and every parameter equal to the
    reference reader's, bit for bit (it was refused before the float
    engine was ported).  A payload of a precision neither package writes,
    and a float payload with a tensor missing, raise ``ArtifactError``."""
    params = rsnn.init_params(rng_key, small_cfg)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, small_cfg.input_dim)), jnp.float32)
    fpath = j_artifact.save_artifact(
        tmp_path / "float", cfg=small_cfg, params=params, backend="fused",
        input_scale=S.calibrate_input_scale(x, small_cfg.input_bits))
    port, ref = artifact.load_artifact(fpath), j_artifact.load_artifact(fpath)
    assert port.precision == ref.precision == "float"
    assert port.packed is None and port.layouts == {}
    assert (port.backend, port.sparse_fc, port.fc_prune_fraction) == \
        ("fused", False, 0.0)
    assert dataclasses.asdict(port.cfg) == {
        k: v for k, v in dataclasses.asdict(ref.cfg).items() if k != "dtype"}
    np.testing.assert_array_equal(port.input_scale.numpy(),
                                  np.asarray(ref.input_scale))
    for name in small_cfg.layer_shapes:
        assert port.params[name].dtype == torch.float32
        np.testing.assert_array_equal(port.params[name].numpy(),
                                      np.asarray(ref.params[name]))
    for i in (0, 1):
        for a, b in zip(port.params[f"lif{i}"], ref.params[f"lif{i}"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    manifest = json.loads((fpath / "manifest.json").read_text())
    (fpath / "manifest.json").write_text(json.dumps(
        dict(manifest, precision="int8")))
    with pytest.raises(artifact.ArtifactError, match="precision"):
        artifact.load_artifact(fpath)
    with np.load(fpath / "tensors.npz") as data:
        arrays = {k: data[k] for k in data.files}
    del arrays["params['lif1'].raw_vth"]
    with pytest.raises(artifact.ArtifactError, match="raw_vth"):
        artifact.params_from_arrays(arrays, small_cfg)


def test_chip_smoke_artifact_loads_in_both_readers(tmp_path):
    """chip_smoke.py's numpy writer produces schema-v2 artifacts the
    reference reads, at the PRUNED widths, with equal arrays: the FC
    pruned 40% as CSC, and its 2:4 magnitude mask as N:M and as CSC.  The
    N:M packer it writes with (the port's) is the reference's
    ``pack_nm_groups`` byte for byte, its mask ``nm_prune_mask``."""
    from repro.core.layouts import get_layout
    from repro.core.layouts.nm import pack_nm_groups

    cs = _chip_smoke()
    utts = cs.utterances(0, 4)
    refs = {}
    for key, (prune, layout) in cs.ARTIFACTS.items():
        path = cs.write_artifact(tmp_path / layout / str(prune), 0, utts,
                                 prune=prune, fc_layout=layout)
        ref = j_artifact.load_artifact(path)
        assert ref.cfg.hidden_dim == 128 and ref.cfg.fc_dim == 1920
        assert ref.layouts == {"fc_w": layout}
        assert ref.ccfg.fc_prune_fraction == (0.4 if key == "csc" else 0.5)
        port = artifact.load_artifact(path)
        assert port.fc_prune_fraction == ref.ccfg.fc_prune_fraction
        _assert_same(port, ref)
        # the dense and sparse copies of fc_w hold the same matrix
        t = ref.packed.sparse["fc_w"]
        dense = np.asarray(sparse.dequantize(ref.packed.quant["fc_w"]))
        np.testing.assert_array_equal(
            np.asarray(get_layout(layout).unpack(t, 128)), dense)
        refs[key] = ref
    # one seed, one 2:4 mask: the two N:M artifacts hold the same weights
    nm_q = np.asarray(refs["nm"].packed.quant["fc_w"].packed)
    np.testing.assert_array_equal(
        nm_q, np.asarray(refs["nm as csc"].packed.quant["fc_w"].packed))
    rng = np.random.default_rng(0)
    w = rng.normal(size=(18, 7)).astype(np.float32)
    q, scale = cs.quantize_to_int(torch.from_numpy(w))
    q, scale = q.numpy(), scale.numpy()
    for n, m in ((1, 4), (2, 4), (3, 8)):
        keep = cs.nm_prune_mask(torch.from_numpy(w), n, m).bool()
        np.testing.assert_array_equal(keep.numpy(), np.asarray(
            pruning.nm_prune_mask(jnp.asarray(w), n, m)).astype(bool))
        mine = cs.pack_nm_groups(torch.from_numpy(
            np.where(keep.numpy(), q, 0).astype(np.int8)), torch.from_numpy(
            scale), keep, n, m)
        want = pack_nm_groups(q, scale, keep.numpy(), n, m)
        for field in ("packed", "count"):
            np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                          np.asarray(getattr(want, field)))
        assert (mine.n, mine.m, mine.rows) == (n, m, 18)
