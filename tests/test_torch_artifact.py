"""repro_torch's artifact reader vs the reference's.

Artifacts are written by the reference's ``save_artifact`` (dense and CSC
payloads, schema v2 and a rewritten v1) and read by both readers; every
array must be equal bit for bit.  Unported payloads (N:M layout, float)
and broken artifacts raise.  The artifact ``chip_smoke.py`` writes with
numpy loads in the reference reader as well as the port's.
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import artifact as j_artifact
from repro.core import rsnn, sparse
from repro.core.compression import (CompressionConfig, PruneSpec,
                                    init_compression)
from repro.serving import stream as S
from repro_torch.core import artifact
from repro_torch.core.layouts.csc import SparseColumns

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
        assert isinstance(got, SparseColumns)
        for a, b in zip(got, t):
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


def test_unported_payloads_raise(tmp_path, small_cfg, rng_key):
    """An N:M-group tensor and a float payload say they are not ported."""
    nm = CompressionConfig(weight_bits=4, prune_specs=(
        ("fc_w", PruneSpec(kind="nm", n=2, m=4)),))
    path = _write(tmp_path, small_cfg, rng_key, nm)
    assert j_artifact.load_artifact(path).layouts == {"fc_w": "nm_group"}
    with pytest.raises(NotImplementedError, match="nm_group.*not yet ported"):
        artifact.load_artifact(path)

    params = rsnn.init_params(rng_key, small_cfg)
    fpath = j_artifact.save_artifact(tmp_path / "float", cfg=small_cfg,
                                     params=params)
    with pytest.raises(NotImplementedError, match="float"):
        artifact.load_artifact(fpath)


def test_chip_smoke_artifact_loads_in_both_readers(tmp_path):
    """chip_smoke.py's numpy writer produces a schema-v2 artifact the
    reference reads, at the PRUNED widths, with equal arrays."""
    cs = _chip_smoke()
    utts = cs.utterances(0, 4)
    path = cs.write_artifact(tmp_path / "art", 0, utts)
    ref = j_artifact.load_artifact(path)
    assert ref.cfg.hidden_dim == 128 and ref.cfg.fc_dim == 1920
    assert ref.layouts == {"fc_w": "csc"}
    assert ref.ccfg.fc_prune_fraction == 0.4
    _assert_same(artifact.load_artifact(path), ref)
    # the dense and CSC copies of fc_w hold the same matrix
    sc = ref.packed.sparse["fc_w"]
    dense = np.asarray(sparse.dequantize(ref.packed.quant["fc_w"]))
    from repro.core.layouts import get_layout
    np.testing.assert_array_equal(
        np.asarray(get_layout("csc").unpack(sc, 128)), dense)
