"""repro_torch's float engine vs the reference's, on the CPU.

The same seeded numpy inputs go through ``repro`` (the golden model
``core.rsnn.forward``, the float artifact reader, ``kernels.ref`` and the
Pallas mega-step in interpret mode, the float ``CompiledRSNN``) and
``repro_torch`` on CPU tensors (the plain versions the CUDA kernels are
held against on the card).  Tolerances:

* LIF constants: beta and vth within ``1e-6`` relative (sigmoid and
  log-add-exp round an ulp apart in the two frameworks); the pow-2-rounded
  ones exactly, except where the reference's ``log2(vth)`` lies within
  ``1e-6`` of a half-integer or its beta within ``1e-6`` of the midpoint of
  two candidates;
* membrane potentials and logits within ``|d| <= 1e-5 (1 + |y|)``
  (``_close``): float32 sums in another order;
* a spike may differ only where the reference's ``|u - vth|`` is within
  that tolerance (``_near``); a slot whose L0 spikes differ is left out of
  the L1 and logit checks; counters and the input bit sparsity exact.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import ctypes
import dataclasses
import importlib.util
import json
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rsnn_timit as j_timit
from repro.core import artifact as j_artifact
from repro.core import lif as j_lif
from repro.core import rsnn as j_rsnn
from repro.core import spike_ops as j_spike_ops
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import stream as S
from repro_torch.configs import rsnn_timit
from repro_torch.core import artifact, lif, rsnn, spike_ops
from repro_torch.core.compression import \
    CompressionConfig as TCompressionConfig
from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.core.rsnn import RSNNConfig, RSNNState
from repro_torch.core.sparse import PackedRSNN
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import megastep as mega_kernel
from repro_torch.serving import stream as TS
from test_torch_spike import _state_to_torch
from test_torch_stream import ROOT

TOL = 1e-5  # |d| <= TOL * (1 + |y|)
# small_cfg's widths and PRUNED's, as float models
CFGS = {"small": RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2),
        "pruned": rsnn_timit.PRUNED}
BACKENDS = ["ref", "pallas", "spike", "delta", "fused", "fused_spike"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, where=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    ok = np.abs(got - want) <= TOL * (1.0 + np.abs(want))
    assert np.all(ok if where is None else ok[where])


def _j_cfg(cfg: RSNNConfig) -> j_rsnn.RSNNConfig:
    return j_rsnn.RSNNConfig(**dataclasses.asdict(cfg))


def _params(cfg: RSNNConfig, seed: int = 11) -> dict[str, np.ndarray]:
    """Seeded numpy float parameters: weights uniform in a fan-in scaled
    range that keeps both layers firing at moderate rates; LIF parameters
    spread around beta 0.85, vth 1."""
    rng = np.random.default_rng(seed)
    gain = {"l0_wx": 0.06, "l0_wh": 1.5, "l1_wx": 3.0, "l1_wh": 1.5,
            "fc_w": 1.0}
    p = {}
    for name, (k, n) in cfg.layer_shapes.items():
        a = gain[name] / math.sqrt(k)
        p[name] = rng.uniform(-a, a, (k, n)).astype(np.float32)
    h = cfg.hidden_dim
    for i in (0, 1):
        p[f"lif{i}.raw_beta"] = rng.normal(1.7, 0.5, h).astype(np.float32)
        vth = rng.uniform(0.6, 1.6, h)
        p[f"lif{i}.raw_vth"] = np.log(np.expm1(vth)).astype(np.float32)
    return p


def _trees(p: dict[str, np.ndarray]) -> tuple[dict, dict]:
    """The reference's parameter tree and the port's, from one dict."""
    jt, tt = {}, {}
    for name, a in p.items():
        if "." not in name:
            jt[name], tt[name] = jnp.asarray(a), _t(a)
    for i in (0, 1):
        raw = (p[f"lif{i}.raw_beta"], p[f"lif{i}.raw_vth"])
        jt[f"lif{i}"] = j_lif.LIFParams(*map(jnp.asarray, raw))
        tt[f"lif{i}"] = LIFParams(*map(_t, raw))
    return jt, tt


def _frames(cfg, b, t, seed=21):
    return np.random.default_rng(seed).normal(
        size=(b, t, cfg.input_dim)).astype(np.float32)


# ------------------------------------------------------- LIF constants


@pytest.mark.parametrize("hw_rounded", [False, True])
def test_inference_constants_match_reference(hw_rounded):
    rng = np.random.default_rng(7)
    raw_beta = (rng.normal(size=20_000) * 3).astype(np.float32)
    raw_vth = (rng.normal(size=20_000) * 3).astype(np.float32)
    bj, vj = map(np.asarray, j_lif.inference_constants(
        j_lif.LIFParams(jnp.asarray(raw_beta), jnp.asarray(raw_vth)),
        hw_rounded))
    bt, vt = lif.inference_constants(LIFParams(_t(raw_beta), _t(raw_vth)),
                                     hw_rounded)
    assert bt.dtype == vt.dtype == torch.float32
    bt, vt = bt.numpy(), vt.numpy()
    if not hw_rounded:
        np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=0)
        np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0)
        return
    beta = np.asarray(j_lif.beta_of(j_lif.LIFParams(jnp.asarray(raw_beta),
                                                    jnp.asarray(raw_vth))))
    vth = np.asarray(j_lif.vth_of(j_lif.LIFParams(jnp.asarray(raw_beta),
                                                  jnp.asarray(raw_vth))))
    ks = 2.0 ** -np.arange(1, 6)
    cands = np.sort(np.concatenate([ks, 1 - ks]))
    mids = (cands[1:] + cands[:-1]) / 2
    tie_b = (np.abs(beta[:, None] - mids) <= 1e-6).any(axis=1)
    e = np.log2(np.maximum(vth, 1e-8))
    tie_v = np.abs(e - np.floor(e) - 0.5) <= 1e-6
    np.testing.assert_array_equal(bt[~tie_b], bj[~tie_b])
    np.testing.assert_array_equal(vt[~tie_v], vj[~tie_v])
    assert set(np.unique(vt)) <= set(2.0 ** np.arange(-4, 5))
    assert set(np.unique(bt)) <= set(cands.astype(np.float32))


def test_round_pow2_on_equal_inputs_is_exact():
    """On the same beta/vth the two roundings agree bit for bit, ties to
    the first candidate and half to even included."""
    beta = np.float32([0.5, 0.75, 0.625, 0.015625, 0.999, 0.2, 0.046875])
    vth = np.float32([1.0, 1.5, 3.0, 0.001, 40.0, 2 ** 0.5, 0.75])
    np.testing.assert_array_equal(
        lif.round_beta_pow2(_t(beta)).numpy(),
        np.asarray(j_lif.round_beta_pow2(jnp.asarray(beta))))
    np.testing.assert_array_equal(
        lif.round_vth_pow2(_t(vth)).numpy(),
        np.asarray(j_lif.round_vth_pow2(jnp.asarray(vth))))


def test_sparsity_stats_equal_reference():
    rng = np.random.default_rng(3)
    q = np.round(rng.normal(size=(4, 9, 40)) * 40).clip(-128, 127) \
        .astype(np.float32)
    s = (rng.random((2, 4, 16)) < 0.3).astype(np.float32)
    assert float(spike_ops.input_bit_sparsity(_t(q))) == \
        float(j_spike_ops.input_bit_sparsity(jnp.asarray(q)))
    assert float(spike_ops.spike_sparsity(_t(s))) == \
        float(j_spike_ops.spike_sparsity(jnp.asarray(s)))


def test_baseline_config_is_the_reference_one():
    assert dataclasses.asdict(rsnn_timit.BASELINE) == {
        k: v for k, v in dataclasses.asdict(j_timit.BASELINE).items()
        if k != "dtype"}
    n = sum(k * m for k, m in rsnn_timit.BASELINE.layer_shapes.values())
    assert (n, n * 4) == (698_368, 2_793_472)  # the paper's 2.79-MB model


# ------------------------------------------------------ the golden model


def _near(stim, u0, h0, beta, vth) -> np.ndarray:
    """(B, H): where the LIF chain over ``stim`` (TS, B, H) comes within
    tolerance of the threshold at some time step (float64 replay)."""
    u, h = np.asarray(u0, np.float64), np.asarray(h0, np.float64)
    beta, vth = np.asarray(beta, np.float64), np.asarray(vth, np.float64)
    near = np.zeros(u.shape, bool)
    for s in np.asarray(stim, np.float64):
        u = s + beta * u * (1.0 - h)
        near |= np.abs(u - vth) <= TOL * (1.0 + np.abs(u))
        h = (u >= vth).astype(np.float64)
    return near


@pytest.mark.parametrize("width", CFGS)
@pytest.mark.parametrize("hw_rounded", [False, True])
def test_frame_step_teacher_forced_matches_reference(width, hw_rounded):
    """Each frame starts both golden models from the reference's state; a
    slot whose spikes differ must be near the threshold in that layer."""
    cfg = dataclasses.replace(CFGS[width], hw_rounded_lif=hw_rounded)
    jcfg = _j_cfg(cfg)
    jp, tp = _trees(_params(cfg))
    x = _frames(cfg, 4, 5)
    xq = np.asarray(j_spike_ops.quantize_input(jnp.asarray(x),
                                               cfg.input_bits)[0])
    consts = [tuple(map(np.asarray, j_lif.inference_constants(
        jp[f"lif{i}"], hw_rounded))) for i in (0, 1)]
    state = j_rsnn.init_state(jcfg, 4)
    fired = 0.0
    for t in range(xq.shape[1]):
        sj, (lj, aux_j) = j_rsnn.frame_step(jp, state, jnp.asarray(xq[:, t]),
                                            jcfg)
        st, (lt, aux_t) = rsnn.frame_step(tp, _state_to_torch(state),
                                          _t(xq[:, t]), cfg)
        w = {n: np.asarray(jp[n], np.float64) for n in cfg.layer_shapes}
        h0 = np.asarray(state.h0, np.float64)
        stim0 = xq[:, t] @ w["l0_wx"] + h0 @ w["l0_wh"]
        near0 = _near(stim0, state.lif0.u, state.lif0.spike,
                      *consts[0]).any(axis=1)
        diff0 = (st.h0.numpy() != np.asarray(sj.h0)).any(axis=(0, 2))
        assert not (diff0 & ~near0).any()
        s0 = np.asarray(sj.h0, np.float64)
        stim1 = s0 @ w["l1_wx"] + np.asarray(state.h1) @ w["l1_wh"]
        near1 = _near(stim1, state.lif1.u, state.lif1.spike,
                      *consts[1]).any(axis=1)
        diff1 = (st.h1.numpy() != np.asarray(sj.h1)).any(axis=(0, 2))
        assert not (diff1 & ~diff0 & ~near1).any()
        keep = ~(diff0 | diff1)
        _close(st.lif0.u.numpy()[keep], np.asarray(sj.lif0.u)[keep])
        _close(st.lif1.u.numpy()[keep], np.asarray(sj.lif1.u)[keep])
        _close(lt.numpy()[keep], np.asarray(lj)[keep])
        if keep.all():
            for k in aux_j:
                _close(aux_t[k].numpy(), aux_j[k])
        fired += float(np.asarray(sj.h1).mean())
        state = sj
    assert fired > 0.0  # the layers fire


@pytest.mark.parametrize("width", CFGS)
@pytest.mark.parametrize("hw_rounded", [False, True])
def test_forward_matches_reference(width, hw_rounded):
    """``forward`` over 6 frames from zero state (these seeds put no
    potential within rounding of a threshold, so no spike differs): the
    logits, the final state and the rates within tolerance, the input
    bit sparsity exact."""
    cfg = dataclasses.replace(CFGS[width], hw_rounded_lif=hw_rounded)
    jp, tp = _trees(_params(cfg, seed=12))
    x = _frames(cfg, 3, 6, seed=22)
    lj, sj, aj = j_rsnn.forward(jp, jnp.asarray(x), _j_cfg(cfg))
    lt, st, at = rsnn.forward(tp, _t(x), cfg)
    assert lt.shape == (3, 6, cfg.fc_dim)
    for a, b in ((st.h0, sj.h0), (st.h1, sj.h1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(lt.numpy(), lj)
    _close(st.lif1.u.numpy(), sj.lif1.u)
    assert sorted(at) == sorted(aj)
    assert float(at["input_bit_sparsity"]) == \
        float(aj["input_bit_sparsity"])
    for k in aj:
        _close(at[k].numpy(), aj[k])
    assert 0.02 < float(at["spike_rate_l1"].mean()) < 0.6


# ------------------------------------------------------------ artifacts


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_float_artifact_is_save_artifacts(tmp_path):
    """chip_smoke.py's numpy writer of the float BASELINE artifact writes
    what the reference's ``save_artifact(params=...)`` writes for the same
    parameters: the same manifest and the same arrays, keys in the same
    order, bit for bit; both readers load it."""
    cs = _chip_smoke()
    cfg = rsnn_timit.BASELINE
    utts = cs.utterances(0, 4)
    mine = cs.write_float_artifact(tmp_path / "mine", 0, utts)
    flat = cs.float_params(0, cfg)
    p = {k.split("'")[1] + (k.split("]")[-1] if "lif" in k else ""): v
         for k, v in flat.items()}
    jp, _ = _trees(p)
    theirs = j_artifact.save_artifact(
        tmp_path / "theirs", cfg=_j_cfg(cfg), params=jp,
        input_scale=cs.input_scale(utts), backend="pallas")
    assert json.loads((mine / "manifest.json").read_text()) == \
        json.loads((theirs / "manifest.json").read_text())
    with np.load(mine / "tensors.npz") as a, \
            np.load(theirs / "tensors.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    art, ref_art = artifact.load_artifact(mine), j_artifact.load_artifact(mine)
    assert art.precision == ref_art.precision == "float"
    beta, vth = lif.inference_constants(art.params["lif0"])
    np.testing.assert_allclose(beta.numpy(), 0.9, rtol=1e-6)
    np.testing.assert_allclose(vth.numpy(), 1.0, rtol=1e-6)


@pytest.fixture(scope="module")
def float_paths(tmp_path_factory):
    """Reference-written float artifacts at each width of ``CFGS``."""
    out = {}
    for width, cfg in CFGS.items():
        jp, _ = _trees(_params(cfg))
        x = jnp.asarray(_frames(cfg, 2, 10, seed=3))
        out[width] = j_artifact.save_artifact(
            tmp_path_factory.mktemp(width) / "float", cfg=_j_cfg(cfg),
            params=jp, input_scale=S.calibrate_input_scale(x, cfg.input_bits),
            backend="fused")
    return out


def test_float_artifact_carries_weights_across(float_paths):
    art = artifact.load_artifact(float_paths["small"])
    ref_art = j_artifact.load_artifact(float_paths["small"])
    assert art.precision == "float" and art.packed is None
    with np.load(float_paths["small"] / "tensors.npz") as data:
        params = artifact.params_from_arrays(
            {k: data[k] for k in data.files}, art.cfg)
    for name in art.cfg.layer_shapes:
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(ref_art.params[name]))
    for i in (0, 1):
        for a, b in zip(params[f"lif{i}"], ref_art.params[f"lif{i}"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    arrays = {f"params['{n}']": params[n].numpy()
              for n in art.cfg.layer_shapes}
    arrays.update({f"params['lif{i}'].{f}": getattr(params[f"lif{i}"], f)
                   .numpy() for i in (0, 1) for f in LIFParams._fields})
    artifact.params_from_arrays(arrays, art.cfg)  # complete: loads
    with pytest.raises(artifact.ArtifactError, match="l1_wx"):
        artifact.params_from_arrays(
            {k: v for k, v in arrays.items() if "l1_wx" not in k}, art.cfg)
    arrays["params['l0_wx']"] = arrays["params['l0_wx']"][:-1]
    with pytest.raises(artifact.ArtifactError, match="l0_wx"):
        artifact.params_from_arrays(arrays, art.cfg)


# ------------------------------------------------------- megastep_ref


def _mega_operands(cfg: RSNNConfig, frames: int, seed: int = 41) -> tuple:
    """Seeded numpy operands of the float mega-step: 8-bit integer frames,
    random 0/1 trains and LIF carries, the float weights of ``_params``
    and their LIF constants."""
    rng = np.random.default_rng(seed)
    d, h, b = cfg.input_dim, cfg.hidden_dim, 4
    ts = cfg.num_ts
    p = _params(cfg)

    def spikes(*shape):
        return (rng.random(shape) < 0.3).astype(np.float32)

    x = np.clip(np.round(rng.normal(size=(frames, b, d)) * 40), -127,
                127).astype(np.float32)
    state = (spikes(ts, b, h), rng.normal(size=(b, h)).astype(np.float32),
             spikes(b, h), spikes(ts, b, h),
             rng.normal(size=(b, h)).astype(np.float32), spikes(b, h))
    lif_c = tuple(np.asarray(c) for i in (0, 1)
                  for c in j_lif.inference_constants(j_lif.LIFParams(
                      jnp.asarray(p[f"lif{i}.raw_beta"]),
                      jnp.asarray(p[f"lif{i}.raw_vth"]))))
    wargs = tuple(p[n] for n in ("l0_wx", "l0_wh", "l1_wx", "l1_wh"))
    return (x, *state, *lif_c, wargs, (p["fc_w"],))


def _mega_near(args) -> np.ndarray:
    """Per slot: whether the chain, replayed frame by frame in float64
    with dense products, comes within tolerance of a threshold in either
    layer at some time step of some frame."""
    x, s0, u0, h0, s1, u1, h1, b0, v0, b1, v1, w, _ = (
        tuple(np.asarray(t, np.float64) for t in a) if isinstance(a, tuple)
        else np.asarray(a, np.float64) for a in args)
    w0x, w0h, w1x, w1h = w
    near = np.zeros(x.shape[1], bool)
    for xf in x:
        stim0 = xf @ w0x + s0 @ w0h
        near |= _near(stim0, u0, h0, b0, v0).any(axis=1)
        s0, u0 = _chain(stim0, u0, h0, b0, v0)
        h0 = s0[-1]
        stim1 = s0 @ w1x + s1 @ w1h
        near |= _near(stim1, u1, h1, b1, v1).any(axis=1)
        s1, u1 = _chain(stim1, u1, h1, b1, v1)
        h1 = s1[-1]
    return near


def _chain(stim, u, h, beta, vth):
    out = []
    for s in stim:
        u = s + beta * u * (1.0 - h)
        h = (u >= vth).astype(np.float64)
        out.append(h)
    return np.stack(out), u


OUT_SLOT_AXIS = (1, 0, 1, 0, 1, 2, 2, 1, 1)  # the slot axis of each output


def _assert_mega(got, want, near):
    """Nine outputs on the slots away from the threshold: spikes and
    counters exact, u and logits within ``_close``'s tolerance; the input
    one-bits exact everywhere."""
    keep = ~near
    for i, (g, w, axis) in enumerate(zip(got, want, OUT_SLOT_AXIS)):
        g = np.moveaxis(np.asarray(g), axis, 0)
        w = np.moveaxis(np.asarray(w), axis, 0)
        assert g.shape == w.shape
        if i == 8:
            np.testing.assert_array_equal(g, w)
        elif i in (1, 3, 4):
            _close(g[keep], w[keep])
        else:
            np.testing.assert_array_equal(g[keep], w[keep])


@pytest.mark.parametrize("width", CFGS)
@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("spike", [False, True])
def test_megastep_ref_float_matches_reference(width, frames, spike):
    """The port's plain K6/K7 with float weights and the ``dense_float``
    FC against the reference's oracle and its Pallas mega-step in
    interpret mode (same ``spike`` mode), and against the port's other
    mode, with the near-threshold rule per slot."""
    cfg = CFGS[width]
    args = _mega_operands(cfg, frames)
    pargs = tuple(tuple(map(_t, a)) if isinstance(a, tuple) else _t(a)
                  for a in args)
    jargs = tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                  else jnp.asarray(a) for a in args)
    kw = dict(precision="float", fc_mode="dense_float", input_bits=8)
    got = ref.megastep_ref(*pargs, **kw, spike=spike)
    near = _mega_near(args)
    assert near.sum() <= 1  # the check covers most slots
    _assert_mega(got, jref.megastep_ref(*jargs, **kw), near)
    _assert_mega(got, jops.megastep(*jargs, **kw, spike=spike), near)
    _assert_mega(got, ref.megastep_ref(*pargs, **kw, spike=not spike), near)
    s1 = got[2].numpy()
    assert 0.05 < float(s1.mean()) < 0.95
    assert got[4].shape == (frames, 4, cfg.fc_dim)
    # through the dispatch, on CPU tensors: the plain version, no launch
    before = (mega_kernel.launches, mega_kernel.spike_launches)
    again = ops.megastep(*pargs, **kw, spike=spike)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert (mega_kernel.launches, mega_kernel.spike_launches) == before


def test_megastep_precision_and_fc_mode_must_agree():
    args = tuple(tuple(map(_t, a)) if isinstance(a, tuple) else _t(a)
                 for a in _mega_operands(CFGS["small"], 1))
    with pytest.raises(ValueError, match="dense_int4"):
        ref.megastep_ref(*args, precision="float", fc_mode="dense_int4",
                         input_bits=8)
    with pytest.raises(ValueError, match="dense_float"):
        ref.megastep_ref(*args, precision="int4", fc_mode="dense_float",
                         input_bits=8)
    with pytest.raises(ValueError, match="precision"):
        ops.megastep(*args, precision="int8", fc_mode="dense_float",
                     input_bits=8)
    assert _build._lib is None  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.megastep(*args, precision="float", fc_mode="dense_float",
                             input_bits=8)
    w_fc = args[-1][0]
    a, values, scale, n, nnz = mega_kernel._fc_operands(
        "dense_float", (w_fc,), 16)
    assert a.data_ptr() == w_fc.data_ptr() and values is scale is None
    assert (n, nnz) == (12, 0)
    with pytest.raises(ValueError, match="dense_float"):
        mega_kernel._fc_operands("dense_float", (w_fc[:-1],), 16)
    with pytest.raises(ValueError, match="float32"):
        mega_kernel._layer_weights(tuple(t.double() for t in args[11]),
                                   "float", 8, 16, torch.device("cpu"))


def test_launch_signature_matches_the_kernel_source():
    """``_ARGS`` lists the C parameters of ``megastep_launch`` in order
    (pointers as ``c_void_p``, ints as ``c_int``), and ``FC_MODES`` and
    ``PRECISIONS`` the codes ``csrc/megastep.cu`` defines: nothing else
    checks a ctypes signature against the C one."""
    src = (ROOT / "src/repro_torch/csrc/megastep.cu").read_text()
    sig = re.search(r'extern "C" int megastep_launch\((.*?)\)\s*\{', src,
                    re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all(p.startswith(("const void*", "void*", "int ")) for p in params)
    assert kinds == mega_kernel._ARGS
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[19:21] == ["precision", "fc_mode"]
    codes = dict(re.findall(r"constexpr int k(Fc\w+|Precision\w+) = (\d+);",
                            src))
    assert {"dense_int4": codes["FcDenseInt4"], "csc": codes["FcCsc"],
            "nm": codes["FcNm"], "dense_float": codes["FcDenseFloat"]} == \
        {k: str(v) for k, v in mega_kernel.FC_MODES.items()}
    assert {"int4": codes["PrecisionInt4"],
            "float": codes["PrecisionFloat"]} == \
        {k: str(v) for k, v in mega_kernel.PRECISIONS.items()}


# ------------------------------------------------------ served frames


def _float_engines(path, backend, **kw):
    art_j = j_artifact.load_artifact(path)
    art_t = artifact.load_artifact(path)
    ref_eng = S.CompiledRSNN.from_artifact(path, S.EngineConfig(
        backend=backend, precision="float", input_scale=art_j.input_scale,
        **kw))
    port = TS.CompiledRSNN.from_artifact(path, TS.EngineConfig(
        backend=backend, precision="float", input_scale=art_t.input_scale,
        **kw), device="cpu")
    return ref_eng, port


def _assert_float_frames(ref_eng, port, frames: int = 3, seed: int = 21):
    """Teacher-forced frames (``test_torch_spike.assert_frames_match`` at
    float): both engines start each frame from the reference's state;
    spikes and counters exact (these seeds put no potential within
    rounding of a threshold), u, the delta carries and logits within
    tolerance."""
    cfg, b = ref_eng.cfg, 4
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(frames, b, cfg.input_dim)).astype(np.float32)
    x[1, 0] = x[0, 0]  # a repeated frame: the delta gate holds the row
    active = np.array([True, True, False, True])
    state = ref_eng.init_state(b)
    for t in range(frames):
        xq_j = ref_eng.quantize_features(jnp.asarray(x[t]))
        xq_p = port.quantize_features(x[t])
        np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
        sj, lj, aj = ref_eng.step_masked(state, xq_j, jnp.asarray(active))
        sp, lp, ap = port.step_masked(_state_to_torch(state), xq_p,
                                      torch.from_numpy(active))
        core_j, core_p = getattr(sj, "rsnn", sj), getattr(sp, "rsnn", sp)
        for a, c in ((core_p.h0, core_j.h0), (core_p.h1, core_j.h1)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        _close(core_p.lif0.u.numpy(), core_j.lif0.u)
        _close(core_p.lif1.u.numpy(), core_j.lif1.u)
        if hasattr(sj, "x_prev"):
            np.testing.assert_array_equal(sp.x_prev.numpy(),
                                          np.asarray(sj.x_prev))
            _close(sp.pre.numpy(), sj.pre)
        _close(lp.numpy(), lj)
        np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
        state = sj
    assert float(np.asarray(getattr(state, "rsnn", state).h1).mean()) > 0.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("width", CFGS)
def test_float_backends_teacher_forced_match_reference(float_paths, backend,
                                                       width):
    ref_eng, port = _float_engines(float_paths[width], backend)
    assert port.ops.name == {"pallas": "cuda"}.get(backend, backend)
    assert port.engine.precision == "float" and port.packed is None
    _assert_float_frames(ref_eng, port)


@pytest.mark.parametrize("backend", ["ref", "fused_spike"])
def test_float_streamloop_matches_reference_loop(float_paths, backend):
    """``from_artifact`` derives the float engine from the manifest; a v1
    StreamLoop against the reference's: sids, steps, the measured sparsity
    and MMAC/s equal, logits within tolerance."""
    cfg = CFGS["small"]
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, cfg.input_dim)).astype(np.float32)
            for t in (7, 10, 4, 0, 6, 3)]
    loops = []
    for eng, loop_cls in (
            (S.CompiledRSNN.from_artifact(float_paths["small"],
                                          backend=backend), S.StreamLoop),
            (TS.CompiledRSNN.from_artifact(float_paths["small"],
                                           backend=backend, device="cpu"),
             TS.StreamLoop)):
        assert eng.engine.precision == "float"
        loop = loop_cls(eng, batch_slots=2, pipeline_depth=0)
        for u in utts:
            loop.submit(u)
        loops.append((loop, loop.run()))
    (lj, dj), (lp, dp) = loops
    assert [r.sid for r in dp] == [r.sid for r in dj]
    assert (lp.steps, lp.frames_served) == (lj.steps, lj.frames_served)
    assert dataclasses.asdict(lp.sparsity_profile()) == \
        dataclasses.asdict(lj.sparsity_profile())
    assert lp.mmac_per_second() == lj.mmac_per_second()
    for a, b in zip(dp, dj):
        _close(a.stacked_logits(), b.stacked_logits())


def test_float_chunk_step_is_one_launch_of_frame_steps(float_paths,
                                                       monkeypatch):
    """``fused`` at float: a 3-frame ``_chunk_step`` is one mega-step call
    and equals three ``_frame_step`` calls bit for bit."""
    port = TS.CompiledRSNN.from_artifact(float_paths["small"],
                                         backend="fused", device="cpu")
    x = torch.from_numpy(_frames(CFGS["small"], 3, 4, seed=17)
                         .transpose(1, 0, 2).copy())
    xq = port.quantize_features(x)
    calls = []
    real = ops.megastep
    monkeypatch.setattr(ops, "megastep", lambda *a, **k: calls.append(
        k["precision"]) or real(*a, **k))
    state_c, logits_c, _ = port._chunk_step(port.init_state(3), xq)
    assert calls == ["float"]
    state_f, logits_f = port.init_state(3), []
    for x_t in xq:
        state_f, lg, _ = port._frame_step(state_f, x_t)
        logits_f.append(lg)
    assert torch.equal(logits_c, torch.stack(logits_f))
    assert torch.equal(state_c.h1, state_f.h1)
    assert torch.equal(state_c.lif1.u, state_f.lif1.u)


# ------------------------------------------------------------ refusals


def test_engine_config_precision_validation():
    assert TS.EngineConfig().precision == S.EngineConfig().precision \
        == "float"
    with pytest.raises(ValueError, match="unknown precision"):
        TS.EngineConfig(precision="int8")
    with pytest.raises(ValueError, match="int4"):
        TS.EngineConfig(precision="float", sparse_fc=True)
    with pytest.raises(ValueError, match="int4"):
        TS.EngineConfig(backend="sparse")
    TS.EngineConfig(backend="sparse", precision="int4")  # ok


def test_payload_and_precision_mismatches_raise(float_paths):
    path = float_paths["small"]
    with pytest.raises(ValueError, match="does not match"):
        TS.CompiledRSNN.from_artifact(path, TS.EngineConfig(
            precision="int4"), device="cpu")
    art = artifact.load_artifact(path)
    with pytest.raises(ValueError, match="parameter dict"):
        TS.CompiledRSNN(art.cfg, None, device="cpu")
    with pytest.raises(ValueError, match="CompressionConfig"):
        TS.CompiledRSNN(art.cfg, art.params, TS.EngineConfig(
            precision="int4"), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        TS.CompiledRSNN(art.cfg, art.params, device="cpu",
                        packed=PackedRSNN({}, {}, {}))
    bad = dict(art.params, lif1=art.params["lif1"]._replace(
        raw_vth=art.params["lif1"].raw_vth[:-1]))
    with pytest.raises(ValueError, match="lif1.raw_vth"):
        TS.CompiledRSNN(art.cfg, bad, device="cpu")
    # a float model has no pruned FC, whatever the compression config says
    eng = TS.CompiledRSNN(art.cfg, art.params, TS.EngineConfig(),
                          TCompressionConfig(fc_prune_frac=0.4),
                          device="cpu")
    assert eng.engine.backend == "jnp" and eng.fc_prune_frac == 0.0
    state = eng.init_state(2)
    assert isinstance(state, RSNNState) and isinstance(state.lif0, LIFState)
