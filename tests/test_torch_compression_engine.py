"""repro_torch's in-process int4 engines, seeded parameters and data,
``chip_smoke.py``'s artifacts and the serving example, vs the reference's
on the CPU: the second half of tests/test_torch_compression.py, with its
recipes and helpers.

* the in-process int4 engines on teacher-forced frames: ``pallas`` and
  ``sparse`` logits bit-equal, ``fused`` logits bit-equal with the
  zero-skip FC and within ``1e-5 (1 + |y|)`` with the dense int4 one
  (``test_torch_spike._close``), u within that tolerance; an engine
  bit-equal to its reloaded artifact;
* bit for bit: the LIF init and ``TimitLikeStream.batch``; the FC fields
  ``chip_smoke.write_artifact`` packs and the artifacts' bytes (sha256);
* ``examples/stream_asr_torch.py`` in process and as a save/load pair.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import json
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import lif as j_lif
from repro.core import rsnn as j_rsnn
from repro.core.compression import quantization as j_quant
from repro.core.layouts import csc as j_csc
from repro.core.layouts import nm as j_nm
from repro.data import synthetic as j_synthetic
from repro.serving import stream as S
from repro_torch.core import artifact, lif, rsnn, sparse
from repro_torch.core.compression import compress
from repro_torch.data import synthetic
from repro_torch.serving import stream as TS
from test_torch_compression import (SMALL, _assert_layout_tensor_equal,
                                    _assert_packed_equal, _chip_smoke,
                                    _configs, _equal, _params, _t)
from test_torch_spike import assert_frames_match
from test_torch_stream import ROOT


# ----------------------------------------------------- in-process engines


def _in_process(backend, recipe, sparse_fc=False):
    pj, pt, cfg_j, cfg_t = _params(SMALL, seed=11)
    cj, ct = _configs(recipe)
    x = np.random.default_rng(3).normal(size=(20, 8)).astype(np.float32)
    ref_eng = S.CompiledRSNN(cfg_j, pj, S.EngineConfig(
        backend=backend, precision="int4", sparse_fc=sparse_fc,
        input_scale=S.calibrate_input_scale(jnp.asarray(x), 8)), cj)
    port = TS.CompiledRSNN(cfg_t, pt, TS.EngineConfig(
        backend=backend, precision="int4", sparse_fc=sparse_fc,
        input_scale=TS.calibrate_input_scale(_t(x), 8)), ct, device="cpu")
    return ref_eng, port


@pytest.mark.parametrize("backend,recipe,sparse_fc,exact", [
    ("pallas", "csc", False, True), ("sparse", "csc", True, True),
    ("sparse", "nm", True, True), ("fused", "csc", True, True),
    ("fused", "nm", True, True), ("fused", "csc", False, False)])
def test_in_process_int4_engine_matches_reference(backend, recipe, sparse_fc,
                                                  exact):
    ref_eng, port = _in_process(backend, recipe, sparse_fc)
    _assert_packed_equal(port.packed, ref_eng.packed)
    assert port.fc_prune_frac == ref_eng.fc_prune_frac
    assert_frames_match(ref_eng, port, exact_logits=exact)


def test_in_process_engine_packs_its_cstate_and_refuses(monkeypatch):
    _, pt, _, cfg_t = _params(SMALL)
    _, ct = _configs("mixed")
    eng = TS.CompiledRSNN(cfg_t, pt, TS.EngineConfig(precision="int4"), ct,
                          compress.init_compression(pt, ct), device="cpu")
    _assert_packed_equal(eng.packed, sparse.pack_model(
        pt, cfg_t, ct, compress.init_compression(pt, ct)))
    int4 = TS.EngineConfig(precision="int4")
    with pytest.raises(ValueError, match="params to pack"):
        TS.CompiledRSNN(cfg_t, None, int4, ct, device="cpu")
    with pytest.raises(ValueError, match="weight_bits set"):
        TS.CompiledRSNN(cfg_t, pt, int4, compress.CompressionConfig(),
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TS.CompiledRSNN(cfg_t, pt, int4, ct)  # device="cuda" by default


def test_in_process_engine_equals_its_reloaded_artifact(tmp_path):
    _, port = _in_process("fused", "nm", sparse_fc=True)
    path = artifact.save_artifact(
        tmp_path / "a", cfg=port.cfg, packed=port.packed,
        ccfg=_configs("nm")[1], input_scale=port._input_scale,
        backend="fused", sparse_fc=True)
    back = TS.CompiledRSNN.from_artifact(path, device="cpu")
    _assert_packed_equal(back.packed, port.packed)
    assert back.fc_prune_frac == port.fc_prune_frac == 0.5
    rng = np.random.default_rng(12)
    utts = [rng.normal(size=(t, 8)).astype(np.float32) for t in (5, 3, 7)]
    logits = []
    for eng in (port, back):
        loop = TS.StreamLoop(eng, batch_slots=2)
        for u in utts:
            loop.submit(u)
        logits.append([r.stacked_logits() for r in loop.run()])
    for a, b in zip(*logits):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ params, data, example


def test_init_params_shapes_dtypes_and_bounds():
    cfg = rsnn.RSNNConfig(**SMALL)
    params = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    j_params = j_rsnn.init_params(__import__("jax").random.PRNGKey(0),
                                  j_rsnn.RSNNConfig(**SMALL))
    for name, shape in cfg.layer_shapes.items():
        w = params[name]
        assert tuple(w.shape) == shape and w.dtype == torch.float32
        bound = np.float32(1.0) / np.sqrt(np.float32(shape[0]))
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.5 * bound  # spread over the range
    for i in (0, 1):
        for a, b in zip(params[f"lif{i}"], j_params[f"lif{i}"]):
            _equal(a, b)
    again = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(params[n], again[n]) for n in cfg.layer_shapes)
    for a, b in zip(lif.init_lif(5, 0.75, 0.5, device="cpu"),
                    j_lif.init_lif(5, 0.75, 0.5)):
        _equal(a, b)


@pytest.mark.parametrize("step", [0, 3])
def test_timit_like_stream_equals_reference(step):
    cfg = dict(frames=37, seed=5)
    got = synthetic.TimitLikeStream(synthetic.SpeechDataConfig(**cfg)).batch(
        3, step)
    want = j_synthetic.TimitLikeStream(
        j_synthetic.SpeechDataConfig(**cfg)).batch(3, step)
    assert got.keys() == want.keys()
    for k in want:
        _equal(got[k], want[k])


def test_chip_smoke_fc_fields_equal_reference_packers(tmp_path):
    """``chip_smoke.write_artifact`` at seed 0 packs its FC through the
    port's packers: the fields it writes equal the reference's
    ``sparsify_columns`` and ``pack_nm_groups`` on the same q and mask
    (``chip_smoke.seeded_int4``)."""
    cs = _chip_smoke()
    utts = cs.utterances(0, 4)
    for key, (prune, layout) in cs.ARTIFACTS.items():
        path = cs.write_artifact(tmp_path / key.replace(" ", "_"), 0, utts,
                                 prune=prune, fc_layout=layout)
        q, scale, keep = (t.numpy() for t in cs.seeded_int4(
            0, prune=prune)[0]["fc_w"])
        if layout == "csc":
            want = j_csc.sparsify_columns(q, scale, keep)
        else:
            want = j_nm.pack_nm_groups(q, scale, keep, *prune)
        _assert_layout_tensor_equal(
            artifact.load_artifact(path).packed.sparse["fc_w"], want)
        ref = j_artifact.load_artifact(path)
        _assert_layout_tensor_equal(
            artifact.load_artifact(path).packed.sparse["fc_w"],
            ref.packed.sparse["fc_w"])
        _equal(ref.packed.quant["fc_w"].packed, j_quant.pack_int4(q))


def test_chip_smoke_artifacts_byte_equal_to_the_numpy_writers(tmp_path):
    """The artifacts ``chip_smoke.py`` writes through the port's packers
    and ``save_artifact`` hold the bytes its numpy writers wrote (every
    array and the manifest's content), so its serving phases serve the
    same models."""
    cs = _chip_smoke()
    utts = cs.utterances(0, 4)
    paths = {key: cs.write_artifact(tmp_path / key.replace(" ", "_"), 0,
                                    utts, prune=prune, fc_layout=layout)
             for key, (prune, layout) in cs.ARTIFACTS.items()}
    paths["float"] = cs.write_float_artifact(tmp_path / "float", 0, utts)
    assert {key: _digest(p) for key, p in paths.items()} == DIGESTS


# sha256 over the manifest (keys sorted) and every array (name, dtype,
# shape, bytes) of the artifacts the numpy writers of chip_smoke.py wrote
# at seed 0 over ``utterances(0, 4)``
DIGESTS = {
    "csc": "0afa8a1170d9ffdecbc598ba92bc803c19538ed3ed58d63ad589f2706e12c11d",
    "nm": "94725b45ed896dd451ac84ad2b4426c0e4484a1936989b0453ddac4d3b49f818",
    "nm as csc":
        "f63e88c10fafb063a2c699c83391f2591a1c209c3ea49e7e7fcbe3cc09fe543b",
    "float":
        "6e25a3ef670c5909decf1df210f147b57eac8194324dcf6d3d75b3c1c95ea679",
}


def _digest(path: Path) -> str:
    import hashlib

    h = hashlib.sha256()
    manifest = json.loads((path / "manifest.json").read_text())
    h.update(json.dumps(manifest, sort_keys=True).encode())
    with np.load(path / "tensors.npz") as d:
        for k in sorted(d.files):
            a = d[k]
            h.update(f"{k} {a.dtype} {a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _example(*args, cwd) -> str:
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "stream_asr_torch.py"),
         "--device", "cpu", "--slots", "2", "--streams", "4", "--frames",
         "3", *args], capture_output=True, text=True, timeout=300, cwd=cwd)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_example_in_process_and_as_a_save_load_pair(tmp_path):
    """``examples/stream_asr_torch.py`` on the CPU: in process (the 0.101 MB
    model at --hidden 128), then as a --save-artifact / --artifact pair
    that serves the same first predictions."""
    first = _example("--hidden", "128", cwd=tmp_path)
    assert "packed model: 0.101 MB nonzero int4" in first
    assert "backend fused" in first
    saved = _example("--save-artifact", str(tmp_path / "art"), cwd=tmp_path)
    assert "wrote deployment artifact" in saved
    loaded = _example("--artifact", str(tmp_path / "art"), cwd=tmp_path)
    assert "serving from artifact" in loaded

    def preds(out):
        return [ln for ln in out.splitlines() if "first predictions" in ln]

    assert preds(first) == preds(saved) == preds(loaded) != []
    assert math.isfinite(float(first.split(" frames/s")[0].split()[-1]))
