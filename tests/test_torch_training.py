"""repro_torch's training half and accelerator model vs the reference's.

Seeded numpy inputs go through ``repro`` and ``repro_torch`` on the CPU.
Tolerances:

* ``==``: every function of the accelerator model (``model_size_bytes``,
  ``num_params``, ``weight_accesses_per_frame``, ``cycles_per_frame``,
  ``realtime_frequency_hz``, ``E_CYCLE``, ``P_LEAK``, ``power_w``,
  ``energy_per_frame_j``, ``tops_per_watt``) and ``RSNNConfig.num_params``;
* bit for bit: ``spike_fn``'s forward, the values of ``round_beta_pow2``,
  ``round_vth_pow2`` and ``quantize_input`` (against the reference and
  against the pre-straight-through expression), their straight-through
  gradients, every forward spike of ``loss_fn``'s cases, checkpoint leaves
  and restored pipeline stages;
* ``spike_fn``'s surrogate ``(du, dvth)`` and ``quantize_input``'s
  gradient: rtol 1e-6, atol 1e-7 (``dvth`` sums over the batch in
  another order);
* ``loss_fn``'s value against the reference's (its cases in
  tests/test_torch_training_loss.py, with this file's helpers): rtol
  1e-4, atol 1e-6; every gradient leaf against ``jax.grad``: rtol 1e-4
  and an atol of 1e-6 + 5e-4 max |g| over the leaf.  Float32 rounding moves u by ulps,
  the surrogate's slope (up to 2 slope = 50 an ulp) amplifies them into
  the back-propagated terms, and those sum with cancellation over the
  frames, so the error scales with the leaf's largest element, not with
  each element (measured: at most 1.5e-4 of it, at TS = 4);
* ``apply_updates`` over 5 steps, and three ``make_train_step`` steps:
  parameters within rtol 1e-6, atol 1e-6 and rtol 1e-5, atol 1e-6;
  ``schedule`` within rtol 1e-6;
* the exported artifact: the port's reloaded engine bit-equal to its
  in-process engine; the reference's engine over the same artifact within
  1e-5 (``ref`` against the reference's ``jnp``).
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as j_ckpt
from repro.configs import rsnn_timit as j_timit
from repro.core import artifact as j_artifact
from repro.core import complexity as J
from repro.core import lif as j_lif
from repro.core import rsnn as j_rsnn
from repro.core import spike_ops as j_spike_ops
from repro.core.compression import compress as j_compress
from repro.serving import stream as S
from repro.training import optimizer as j_opt
from repro.training import rsnn_pipeline as j_pipe
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import rsnn_timit as t_timit
from repro_torch.core import artifact
from repro_torch.core import complexity as C
from repro_torch.core import lif, spike_ops
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compression import compress
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.temporal import TemporalSchedule
from repro_torch.data.synthetic import SpeechDataConfig, TimitLikeStream
from repro_torch.serving import stream as TS
from repro_torch.training import optimizer as opt
from repro_torch.training.rsnn_pipeline import (CompressionPipeline,
                                                PipelineStage,
                                                export_artifact,
                                                make_train_step, main,
                                                paper_stages, run_pipeline)
from test_torch_stream import ROOT

SMALL = {"input_dim": 8, "hidden_dim": 16, "fc_dim": 12}
T, B = 6, 3
# weight ranges that make both layers fire at the small size
RANGE = {"l0_wx": 0.3, "l0_wh": 0.3, "l1_wx": 0.5, "l1_wh": 0.3, "fc_w": 0.5}
LOSS_RTOL, LOSS_ATOL, GRAD_SCALE = 1e-4, 1e-6, 5e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ------------------------------------------------------ accelerator model

CFGS = {"BASELINE": (j_timit.BASELINE, t_timit.BASELINE),
        "PRUNED": (j_timit.PRUNED, t_timit.PRUNED)}


@pytest.mark.parametrize("profile", ["none", "fig18"])
@pytest.mark.parametrize("ts", [1, 2])
@pytest.mark.parametrize("name", ["BASELINE", "PRUNED"])
def test_accelerator_model_equals_reference(name, ts, profile):
    jc, tc = CFGS[name]
    sj, st = ((None, None) if profile == "none"
              else (J.SparsityProfile(), C.SparsityProfile()))
    assert tc.num_params == jc.num_params
    for bits in (32, 8, 4):
        for frac in (0.0, 0.4):
            assert C.model_size_bytes(tc, bits, frac) == \
                J.model_size_bytes(jc, bits, frac)
    for frac in (0.0, 0.4):
        assert C.num_params(tc, frac) == J.num_params(jc, frac)
    for par in (False, True):
        assert C.weight_accesses_per_frame(tc, ts, par) == \
            J.weight_accesses_per_frame(jc, ts, par)
    assert (C.E_CYCLE, C.P_LEAK) == (J.E_CYCLE, J.P_LEAK)
    for merged in (False, True):
        cyc = C.cycles_per_frame(tc, ts, sparsity=st, merged_spike=merged)
        assert cyc == J.cycles_per_frame(jc, ts, sparsity=sj,
                                         merged_spike=merged)
        f = C.realtime_frequency_hz(cyc)
        assert f == J.realtime_frequency_hz(cyc)
        for freq in (100e3, 500e6, f):
            assert C.power_w(freq) == J.power_w(freq)
            assert C.energy_per_frame_j(cyc, freq) == \
                J.energy_per_frame_j(cyc, freq)
            assert C.tops_per_watt(tc, ts, freq_hz=freq, sparsity=st,
                                   merged_spike=merged) == \
                J.tops_per_watt(jc, ts, freq_hz=freq, sparsity=sj,
                                merged_spike=merged)
            assert C.tops_per_watt(tc, ts, freq_hz=freq, cycles=cyc) == \
                J.tops_per_watt(jc, ts, freq_hz=freq, cycles=cyc)


def test_config_is_pruned():
    assert t_timit.CONFIG is t_timit.PRUNED
    want = dataclasses.asdict(j_timit.CONFIG)
    del want["dtype"]
    assert dataclasses.asdict(t_timit.CONFIG) == want


# the paper's numbers, as tests/test_complexity.py holds the reference to
# them, here held against the port
BASE = RSNNConfig(hidden_dim=256)
PRUNED = RSNNConfig(hidden_dim=128)


def test_param_counts_table1():
    assert BASE.num_params == 698368
    assert PRUNED.num_params == 300032
    assert C.num_params(PRUNED, fc_prune_frac=0.4) == 201728


def test_model_sizes_fig12():
    assert C.model_size_bytes(BASE, 32) == pytest.approx(2.79e6, rel=0.01)
    assert C.model_size_bytes(PRUNED, 32) == pytest.approx(1.20e6, rel=0.01)
    assert C.model_size_bytes(PRUNED, 32, 0.4) == pytest.approx(0.81e6,
                                                                rel=0.01)
    final = C.model_size_bytes(PRUNED, 4, 0.4)
    assert final == pytest.approx(0.1e6, rel=0.01)
    assert 1 - final / C.model_size_bytes(BASE, 32) == pytest.approx(
        0.9642, abs=0.001)


def test_mmac_fig13():
    assert C.mmac_per_second(BASE, 2) == pytest.approx(145.8, abs=0.1)
    assert C.mmac_per_second(PRUNED, 2) == pytest.approx(63.08, abs=0.01)
    assert C.mmac_per_second(PRUNED, 1) == pytest.approx(33.59, abs=0.01)


def test_weight_access_dataflow():
    assert C.weight_accesses_per_frame(BASE, 2, parallel_time_steps=False) \
        == pytest.approx(1.458e6, rel=0.01)
    assert C.weight_accesses_per_frame(BASE, 2, parallel_time_steps=True) \
        == pytest.approx(0.77e6, rel=0.01)


def test_cycles_fig17():
    assert C.cycles_per_frame(PRUNED, 2) == 2464
    assert C.cycles_per_frame(PRUNED, 1) == 1312
    sp = C.SparsityProfile()
    assert abs(C.cycles_per_frame(PRUNED, 2, sparsity=sp) - 1224) < 80
    assert abs(C.cycles_per_frame(PRUNED, 1, sparsity=sp) - 574) < 80
    cm = C.cycles_per_frame(PRUNED, 2, sparsity=sp, merged_spike=True)
    assert abs(cm - 895) < 30
    assert C.realtime_frequency_hz(cm) < 100_000
    with pytest.raises(ValueError, match="128"):
        C.cycles_per_frame(RSNNConfig(hidden_dim=100), 2)


def test_mmac_with_skip_trends():
    sp = C.SparsityProfile()
    skip = C.mmac_per_second(PRUNED, 2, sparsity=sp)
    merged = C.mmac_per_second(PRUNED, 2, sparsity=sp, merged_spike=True)
    assert abs(skip - 24.48) < 1.5
    assert abs(merged - 16.01) < 1.5
    assert merged < skip < C.mmac_per_second(PRUNED, 2)
    one = C.mmac_per_second(PRUNED, 1, sparsity=sp)
    assert abs(one - 13.86) < 1.5
    assert 1 - one / C.mmac_per_second(BASE, 2) > 0.89


def test_power_model_reproduces_paper_points():
    assert C.power_w(100e3) == pytest.approx(71.2e-6, rel=1e-6)
    assert C.power_w(500e6) == pytest.approx(35.5e-3, rel=1e-6)
    assert C.energy_per_frame_j(895, 500e6) == pytest.approx(63.5e-9,
                                                             rel=0.01)
    assert C.energy_per_frame_j(895, 100e3) == pytest.approx(
        71.2e-6 * 8.95e-3, rel=0.01)


def test_tops_per_watt_band():
    assert 5.0 < C.tops_per_watt(PRUNED, 2, sparsity=C.SparsityProfile()) \
        < 60.0


# ----------------------------------- surrogate and straight-through grads


@pytest.mark.parametrize("slope", [25.0, 7.5])
@pytest.mark.parametrize("shape", [(5,), (3, 5), (2, 3, 5)])
def test_spike_fn_matches_custom_vjp(shape, slope):
    rng = np.random.default_rng(len(shape))
    u = rng.normal(size=shape).astype(np.float32)
    vth = rng.uniform(0.2, 1.0, size=shape[-1:]).astype(np.float32)
    u.reshape(-1, shape[-1])[0] = vth  # on the threshold: spikes
    g = rng.normal(size=shape).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: j_lif.spike_fn(a, b, slope),
                        jnp.asarray(u), jnp.asarray(vth))
    du_j, dvth_j = vjp(jnp.asarray(g))
    tu = torch.from_numpy(u).requires_grad_(True)
    tv = torch.from_numpy(vth).requires_grad_(True)
    got = lif.spike_fn(tu, tv, slope)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    du, dvth = torch.autograd.grad(got, (tu, tv), torch.from_numpy(g))
    assert dvth.shape == tv.shape
    _close(du, du_j, 1e-6, 1e-7)
    _close(dvth, dvth_j, 1e-6, 1e-7)


def test_pow2_rounding_is_straight_through():
    rng = np.random.default_rng(0)
    beta = np.concatenate([rng.uniform(0.01, 0.99, 61),
                           [0.75, 0.625, 0.5, 0.96875]]).astype(np.float32)
    vth = np.concatenate([rng.uniform(0.01, 40.0, 61),
                          [1.0, 1.5, 2.0 ** 0.5, 0.0]]).astype(np.float32)
    w = rng.normal(size=beta.shape).astype(np.float32)

    def old_beta(b):  # the port's expressions before the repair
        ks = torch.arange(1, 6, dtype=b.dtype)
        cands = torch.cat([torch.exp2(-ks), 1.0 - torch.exp2(-ks)])
        rounded = cands[torch.argmin((b.unsqueeze(-1) - cands).abs(), -1)]
        return b + (rounded - b)

    def old_vth(v):
        rounded = torch.exp2(torch.clamp(torch.round(torch.log2(
            torch.clamp(v, min=1e-8))), -4, 4))
        return v + (rounded - v)

    for jfn, tfn, old, x in (
            (j_lif.round_beta_pow2, lif.round_beta_pow2, old_beta, beta),
            (j_lif.round_vth_pow2, lif.round_vth_pow2, old_vth, vth)):
        tx = torch.from_numpy(x).requires_grad_(True)
        got = tfn(tx)
        want = np.asarray(jfn(jnp.asarray(x)))
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_np(got), _np(old(torch.from_numpy(x))))
        (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tx)
        g_j = jax.grad(lambda a: jnp.sum(jfn(a) * jnp.asarray(w)))(
            jnp.asarray(x))
        np.testing.assert_array_equal(_np(g), np.asarray(g_j))
        np.testing.assert_array_equal(_np(g), w)


@pytest.mark.parametrize("given_scale", [False, True])
def test_quantize_input_is_straight_through(given_scale):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, 8)).astype(np.float32)
    x[0, 0, :3] = [0.5, -1.5, 2.5]  # ties, rounded half to even
    w = rng.normal(size=x.shape).astype(np.float32)
    scale = np.float32(0.02) if given_scale else None
    q_j, s_j = j_spike_ops.quantize_input(
        jnp.asarray(x), 8, None if scale is None else jnp.asarray(scale))
    tx = torch.from_numpy(x).requires_grad_(True)
    q, s = spike_ops.quantize_input(
        tx, 8, None if scale is None else torch.tensor(scale))
    np.testing.assert_array_equal(_np(q), np.asarray(q_j))
    np.testing.assert_array_equal(_np(s), np.asarray(s_j))
    # the port's expression before the repair, on the CPU
    x0 = torch.from_numpy(x)
    s0 = (torch.clamp(x0.abs().max(), min=1e-8) / 127.0 if scale is None
          else torch.tensor(scale))
    xs = x0 / s0
    old = xs + (torch.clamp(torch.round(xs), -128, 127) - xs)
    np.testing.assert_array_equal(_np(q), _np(old))
    (g,) = torch.autograd.grad((q * torch.from_numpy(w)).sum(), tx)
    g_j = jax.grad(lambda a: jnp.sum(j_spike_ops.quantize_input(
        a, 8, None if scale is None else jnp.asarray(scale))[0]
        * jnp.asarray(w)))(jnp.asarray(x))
    assert float(np.abs(np.asarray(g_j)).max()) > 0
    _close(g, g_j, 1e-6, 1e-7)


# --------------------------------------------------------------- loss_fn


def _weights(seed: int, hw: bool):
    """Seeded numpy weights and LIF parameters as (reference params, port
    params, reference cfg, port cfg)."""
    cfg_t = RSNNConfig(**SMALL, hw_rounded_lif=hw)
    cfg_j = j_rsnn.RSNNConfig(**SMALL, hw_rounded_lif=hw)
    rng = np.random.default_rng(seed)
    flat = {f"params['{n}']": (rng.uniform(-1, 1, s)
                               * RANGE[n]).astype(np.float32)
            for n, s in cfg_t.layer_shapes.items()}
    for i in (0, 1):
        flat[f"params['lif{i}'].raw_beta"] = rng.normal(
            2.0, 0.5, 16).astype(np.float32)
        flat[f"params['lif{i}'].raw_vth"] = rng.normal(
            0.5, 0.3, 16).astype(np.float32)
    pt = artifact.params_from_arrays(flat, cfg_t)
    pj = {n: jnp.asarray(flat[f"params['{n}']"]) for n in cfg_t.layer_shapes}
    for i in (0, 1):
        pj[f"lif{i}"] = j_lif.LIFParams(
            jnp.asarray(flat[f"params['lif{i}'].raw_beta"]),
            jnp.asarray(flat[f"params['lif{i}'].raw_vth"]))
    return pj, pt, cfg_j, cfg_t


def _as_port(pj) -> dict:
    flat = {}
    for n, v in pj.items():
        if isinstance(v, j_lif.LIFParams):
            for f in v._fields:
                flat[f"params['{n}'].{f}"] = np.asarray(getattr(v, f))
        else:
            flat[f"params['{n}']"] = np.asarray(v)
    return flat


# ------------------------------------------------------------- optimizer


def _opt_trees(seed: int, named: bool):
    """A (reference, port) parameter tree pair: a factored (130, 140)
    matrix, a small one and a vector pair, the pair a ``LIFParams`` when
    ``named`` (the reference's Adafactor cannot map a NamedTuple leaf)."""
    rng = np.random.default_rng(seed)
    w, fc = (rng.normal(size=s).astype(np.float32) for s in
             ((130, 140), (16, 12)))
    a, b = (rng.normal(size=16).astype(np.float32) for _ in range(2))

    def build(t, lp):
        pair = lp(t(a), t(b)) if named else {"a": t(a), "b": t(b)}
        return {"w": t(w), "fc": t(fc), "lif0": pair}

    return (build(jnp.asarray, j_lif.LIFParams),
            build(lambda v: torch.from_numpy(v.copy()), lif.LIFParams))


def _port_like(template, tree):
    """The reference tree ``tree`` as a port tree of ``template``'s
    structure (leaf for leaf by ``keystr`` key)."""
    from repro_torch.checkpoint.checkpointer import _unflatten

    want = _keyed(tree)
    return _unflatten(template, iter(
        [torch.from_numpy(want[k].copy()) for k, _ in _leaf_items(template)]))


@pytest.mark.parametrize("name", ["adamw", "adamw8bit", "adafactor"])
def test_apply_updates_matches_reference(name):
    """Five steps, each from the reference's parameters and state: every
    float leaf within rtol 1e-6, atol 1e-6, except that an int8 code may
    land one step away where its value lies within ulps of a rounding
    tie; then only the parameter it belongs to may differ more."""
    kw = {"name": name, "lr": 0.05, "warmup_steps": 2, "decay_steps": 6,
          "weight_decay": 0.01}
    jc, tc = j_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    named = name != "adafactor"
    pj, pt = _opt_trees(0, named)
    sj, st = j_opt.init_opt_state(pj, jc), opt.init_opt_state(pt, tc)
    rng = np.random.default_rng(1)
    flips = 0
    for _ in range(5):
        gj, gt = _opt_trees(int(rng.integers(1 << 30)), named)
        pt, st = _port_like(pt, pj), _port_like(st, sj)
        pj, sj, mj = j_opt.apply_updates(pj, gj, sj, jc)
        pt, st, mt = opt.apply_updates(pt, gt, st, tc)
        assert int(st["step"]) == int(sj["step"])
        _close(mt["lr"], mj["lr"], 1e-6, 0)
        _close(mt["grad_norm"], mj["grad_norm"], 1e-6, 0)
        want_s = _keyed(sj)
        flipped: dict[str, np.ndarray] = {}
        for k, a in _leaf_items(st):
            a = _np(a)
            if a.dtype == np.int8:
                d = np.abs(a.astype(int) - want_s[k].astype(int))
                assert d.max() <= 1, k
                # "['m']['w']['q']" -> "['w']"
                key = k.split("]", 1)[1].rsplit("[", 1)[0]
                flipped[key] = flipped.get(key, False) | (d == 1)
            elif k != "['step']":
                _close(a, want_s[k], 1e-6, 1e-6)
        want = _keyed(pj)
        got = dict(_leaf_items(pt))
        assert sorted(got) == sorted(want)
        for k, a in got.items():
            assert a.dtype == torch.float32
            ok = np.isclose(_np(a), want[k], rtol=1e-6, atol=1e-6)
            assert np.all(ok | flipped.get(k, False)), k
            flips += int(np.sum(flipped.get(k, False)))
    assert flips <= 3  # a tie is rare
    assert not any(v.requires_grad for v in opt.tree_leaves(pt))


def test_schedule_corners():
    for kw in ({"warmup_steps": 10, "decay_steps": 100},
               {"warmup_steps": 0, "decay_steps": 100},
               {"warmup_steps": 50, "decay_steps": 50},
               {"warmup_steps": 100, "decay_steps": 10}):
        jc, tc = (j_opt.OptimizerConfig(lr=3e-3, **kw),
                  opt.OptimizerConfig(lr=3e-3, **kw))
        for step in (0, 1, 5, 9, 10, 11, 49, 50, 51, 99, 100, 101, 10**6):
            _close(opt.schedule(tc, step), j_opt.schedule(
                jc, jnp.asarray(step)), 1e-6, 0)
    assert float(opt.schedule(opt.OptimizerConfig(), 0)) == 0.0


# -------------------------------------------------------- training steps


@pytest.mark.parametrize("kind", ["none", "fake_quant"])
def test_train_steps_match_reference(kind):
    """Three ``make_train_step`` steps from weights carried across."""
    pj, pt, cfg_j, cfg_t = _weights(7, False)
    kw = ({} if kind == "none" else {"fc_prune_frac": 0.4, "weight_bits": 4})
    jcc, tcc = (j_compress.CompressionConfig(**kw),
                compress.CompressionConfig(**kw))
    jcs, tcs = (j_compress.init_compression(pj, jcc),
                compress.init_compression(pt, tcc))
    okw = {"name": "adamw", "lr": 3.5e-3, "warmup_steps": 5,
           "decay_steps": 3, "weight_decay": 0.0}
    jo, to = j_opt.OptimizerConfig(**okw), opt.OptimizerConfig(**okw)
    j_step = jax.jit(j_pipe.make_train_step(cfg_j, jo, jcc, jcs, 2))
    t_step = make_train_step(cfg_t, to, tcc, tcs, 2)
    sj = {"params": pj, "opt": j_opt.init_opt_state(pj, jo)}
    st = {"params": pt, "opt": opt.init_opt_state(pt, to)}
    seed = {k: v.clone() for k, v in pt.items()
            if isinstance(v, torch.Tensor)}
    stream = TimitLikeStream(SpeechDataConfig(input_dim=8, frames=T))
    for i in range(3):
        b = stream.batch(4, step=i)
        b["labels"] = b["labels"] % 12
        sj, mj = j_step(sj, {k: jnp.asarray(v) for k, v in b.items()})
        st, mt = t_step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(mt["loss"], mj["loss"], LOSS_RTOL, LOSS_ATOL)
        for k, v in _as_port(sj["params"]).items():
            _close(artifact._flatten_params(st["params"])[k], v, 1e-5, 1e-6)
    # the input parameters stay as they were (the reference donates them)
    for k, v in seed.items():
        assert torch.equal(pt[k], v)
        assert not torch.equal(st["params"][k], v)


# ----------------------------------------------------------- checkpoints


def _tree(scale: float):
    rng = np.random.default_rng(0)
    return {"params": {"fc_w": torch.from_numpy(
        rng.normal(size=(4, 3)).astype(np.float32) * scale),
        "lif0": lif.LIFParams(torch.full((3,), scale),
                              torch.arange(3.0) * scale)},
        "opt": {"step": torch.tensor(int(scale), dtype=torch.int32),
                "m": [torch.ones(2, dtype=torch.int8), (torch.zeros(1),)]}}


def test_checkpointer_round_trip_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save(s, _tree(float(s)), blocking=(s == 3))
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    mf = (tmp_path / "step_3" / "manifest.json").read_text()
    assert '"process_count": 1' in mf and "['params']['lif0'].raw_beta" in mf
    template = _tree(0.0)
    got, step = ck.restore(template)
    assert step == 3
    assert list(got) == list(template)
    assert isinstance(got["params"]["lif0"], lif.LIFParams)
    want = _tree(3.0)
    for (ka, a), (kb, b) in zip(_leaf_items(got), _leaf_items(want)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
    got2, _ = ck.restore(template, step=2)
    assert torch.equal(got2["params"]["fc_w"], _tree(2.0)["params"]["fc_w"])
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(template)


def _leaf_items(tree):
    """(key, leaf) pairs of a port tree, keyed as ``keystr`` keys them."""
    from repro_torch.checkpoint.checkpointer import _flatten

    return _flatten(tree)


def _keyed(tree) -> dict:
    """A reference tree's leaves as numpy arrays by ``keystr`` key."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def test_checkpointer_commit_is_atomic(tmp_path, monkeypatch):
    """A write that dies leaves the committed steps as they were, no
    half-written step, and raises at ``wait``."""
    ck = Checkpointer(tmp_path, keep=3)
    ck.save(1, _tree(1.0), blocking=True)

    def die(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", die)
    with pytest.raises(OSError, match="disk full"):
        ck.save(2, _tree(2.0), blocking=True)
    monkeypatch.undo()
    assert ck.steps() == [1]
    got, _ = ck.restore(_tree(0.0))
    assert torch.equal(got["params"]["fc_w"], _tree(1.0)["params"]["fc_w"])


def test_checkpoint_save_snapshots_before_returning(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree(1.0)
    ck.save(5, tree)
    tree["params"]["fc_w"].add_(100.0)  # the caller trains on
    ck.wait()
    got, _ = ck.restore(_tree(0.0))
    assert torch.equal(got["params"]["fc_w"], _tree(1.0)["params"]["fc_w"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A pipeline stage's checkpoint ({params, masks}) written by either
    package restores in the other, leaf for leaf."""
    pj, pt, _, _ = _weights(3, False)
    masks = {"fc_w": np.asarray(
        np.random.default_rng(0).uniform(size=(16, 12)) < 0.6, np.float32)}
    if writer == "reference":
        j_ckpt.Checkpointer(tmp_path).save(
            4, {"params": pj, "masks": {k: jnp.asarray(v) for k, v in
                                         masks.items()}}, blocking=True)
        template = {"params": opt.tree_map(torch.empty_like, pt),
                    "masks": {"fc_w": torch.empty(16, 12)}}
        got, step = Checkpointer(tmp_path).restore(template)
        got_flat = dict(_leaf_items(got))
    else:
        Checkpointer(tmp_path).save(4, {"params": pt, "masks": {
            k: torch.from_numpy(v) for k, v in masks.items()}},
            blocking=True)
        template = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape, x.dtype), {"params": pj, "masks": masks})
        got, step = j_ckpt.Checkpointer(tmp_path).restore(template)
        got_flat = _keyed(got)
    assert step == 4
    want = {f"['params']{k[len('params'):]}": v
            for k, v in artifact._flatten_params(pt).items()}
    want["['masks']['fc_w']"] = masks["fc_w"]
    assert sorted(got_flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(_np(got_flat[k]), v)


# -------------------------------------------------------------- pipeline
# every case of tests/test_compression_pipeline.py, on the port's pipeline

CFG = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
QAT = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)


def _stream(frames: int = 6):
    return TimitLikeStream(SpeechDataConfig(input_dim=8, num_classes=12,
                                            frames=frames))


def _stages():
    return (PipelineStage("baseline", CFG),
            PipelineStage("qat4", CFG, QAT, init_from="baseline"))


def _pipe(workdir, **kw):
    kw = {"steps": 2, "batch_size": 2, "eval_batches": 1, "log_every": 1,
          "metric_sink": lambda r: None, "device": "cpu", **kw}
    return CompressionPipeline(kw.pop("stages", _stages()),
                               kw.pop("stream", _stream()), workdir=workdir,
                               **kw)


def _matrices(params) -> dict:
    return {k: _np(v).copy() for k, v in params.items()
            if isinstance(v, torch.Tensor)}


def test_interrupted_recipe_resumes_without_retraining(tmp_path):
    first = _pipe(tmp_path)
    results = first.run(stop_after="baseline")
    assert [r.name for r in results] == ["baseline"]
    want = artifact._flatten_params(results[0].params)
    second = _pipe(tmp_path)
    resumed = second.run(resume=True)
    assert [r.name for r in resumed] == ["baseline", "qat4"]
    assert [r["event"] for r in second.history["baseline"]] == ["restored"]
    assert any(r["event"] == "train" for r in second.history["qat4"])
    got = artifact._flatten_params(resumed[0].params)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    assert resumed[0].error_rate == results[0].error_rate
    assert resumed[0].sparsity == results[0].sparsity
    assert resumed[0].size_bytes == results[0].size_bytes


def test_resume_noop_when_all_stages_done(tmp_path):
    first = _pipe(tmp_path).run()
    again = _pipe(tmp_path)
    resumed = again.run(resume=True)
    assert [r.name for r in resumed] == ["baseline", "qat4"]
    for name in ("baseline", "qat4"):
        assert [r["event"] for r in again.history[name]] == ["restored"]
    # the restored compression state carries the training-time masks
    assert set(resumed[1].cstate.masks) == set(first[1].cstate.masks)
    for k, m in first[1].cstate.masks.items():
        assert torch.equal(resumed[1].cstate.masks[k], m)


def test_resume_refuses_changed_recipe(tmp_path):
    _pipe(tmp_path).run(stop_after="baseline")
    with pytest.raises(ValueError, match="different\\s+recipe"):
        _pipe(tmp_path, steps=3).run(resume=True)


def test_resume_invalidates_downstream_of_changed_stage(tmp_path):
    _pipe(tmp_path).run()
    shutil.rmtree(tmp_path / "stages" / "baseline")
    upstream_changed = (PipelineStage("baseline", CFG, seed=123),
                        PipelineStage("qat4", CFG, QAT, init_from="baseline"))
    with pytest.raises(ValueError, match="qat4.*different\\s+recipe"):
        _pipe(tmp_path, stages=upstream_changed).run(resume=True)


def test_resume_refuses_changed_data_config(tmp_path):
    _pipe(tmp_path).run(stop_after="baseline")
    with pytest.raises(ValueError, match="different\\s+recipe"):
        _pipe(tmp_path, stream=_stream(frames=9)).run(resume=True)


def test_resume_requires_workdir():
    with pytest.raises(ValueError, match="workdir"):
        _pipe(None, steps=1).run(resume=True)


def test_run_pipeline_rejects_artifact_on_unquantized_stop(tmp_path):
    with pytest.raises(ValueError, match="quantized stage"):
        run_pipeline(steps=1, batch_size=2, hidden_base=8, hidden_pruned=8,
                     data_cfg=SpeechDataConfig(input_dim=8, num_classes=12,
                                               frames=6),
                     workdir=tmp_path, stop_after="baseline",
                     artifact_path=tmp_path / "a", device="cpu")
    assert not (tmp_path / "stages").exists()


def test_stage_validation():
    with pytest.raises(ValueError, match="duplicate"):
        _pipe(None, stages=(PipelineStage("a", CFG), PipelineStage("a", CFG)))
    with pytest.raises(ValueError, match="earlier stage"):
        _pipe(None, stages=(PipelineStage("a", CFG, init_from="b"),
                            PipelineStage("b", CFG)))
    with pytest.raises(ValueError, match="not a stage"):
        _pipe(None, stages=(PipelineStage("a", CFG),)).run(stop_after="zzz")


def test_metric_records_are_structured(tmp_path):
    records = []
    pipe = _pipe(tmp_path, stages=(PipelineStage("baseline", CFG),),
                 metric_sink=records.append)
    pipe.run()
    assert {r["event"] for r in records} == {"train", "eval"}
    train = [r for r in records if r["event"] == "train"]
    assert all({"stage", "step", "num_ts", "loss",
                "frame_error_rate"} <= set(r) for r in train)
    jsonl = tmp_path / "stages" / "baseline" / "metrics.jsonl"
    once = len(jsonl.read_text().splitlines())
    pipe.run()
    assert len(jsonl.read_text().splitlines()) == once


def test_paper_stages_shape():
    stages = paper_stages(steps=30)
    assert [s.name for s in stages] == ["baseline", "structured",
                                        "unstructured", "qat4"]
    assert stages[2].init_from == "structured"
    assert stages[3].init_from == "unstructured"
    assert stages[3].ccfg.weight_bits == 4
    assert stages[0].cfg.hidden_dim == 256
    assert stages[1].cfg.hidden_dim == 128
    assert stages[0].schedule == TemporalSchedule(stages=((4, 10), (2, 20)))
    j_stages = j_pipe.paper_stages(steps=30)
    for s, js in zip(stages, j_stages):
        assert (s.name, s.init_from, s.lr, s.seed, s.steps) == \
            (js.name, js.init_from, js.lr, js.seed, js.steps)
        assert s.schedule.stages == js.schedule.stages if s.schedule else \
            js.schedule is None


def test_export_artifact_serves_pipeline_output(tmp_path):
    """train (tiny) -> export -> the port's reloaded engine serves the QAT
    stage's exact weights; the artifact loads in the reference too."""
    results = _pipe(tmp_path / "run").run()
    final = results[-1]
    scale = 0.05
    path = export_artifact(final, tmp_path / "art", input_scale=scale,
                           backend="jnp")
    eng_mem = TS.CompiledRSNN(
        final.cfg, final.params,
        TS.EngineConfig(precision="int4", input_scale=scale),
        final.ccfg, final.cstate, device="cpu")
    eng_art = TS.CompiledRSNN.from_artifact(path, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 5, final.cfg.input_dim)).astype(np.float32)
    la, _, _ = eng_art.run(x)
    lb, _, _ = eng_mem.run(x)
    np.testing.assert_array_equal(_np(la), _np(lb))
    art = artifact.load_artifact(path)
    assert art.sparsity == final.sparsity
    report = art.size_report
    assert report == art.manifest["size_report"]
    assert report["broadcast_total_bytes"] == final.size_bytes
    # the reference reads the port's artifact and serves it
    ref = j_artifact.load_artifact(path)
    assert ref.size_report == report
    lr, _, _ = S.CompiledRSNN.from_artifact(path).run(x)
    np.testing.assert_allclose(np.asarray(lr), _np(la), rtol=0, atol=1e-5)


def test_export_artifact_rejects_unquantized_stage(tmp_path):
    results = _pipe(None, stages=(PipelineStage("baseline", CFG),),
                    steps=1).run()
    with pytest.raises(ValueError, match="weight_bits"):
        export_artifact(results[0], tmp_path / "a")


def test_stage_restores_bit_equal_on_its_device(tmp_path):
    """A restored stage's params and masks are the saved tensors, on the
    pipeline's device, float32, the upstream stage's params untouched by
    the downstream stage's training."""
    results = _pipe(tmp_path).run()
    base_before = _matrices(results[0].params)
    assert not np.array_equal(base_before["fc_w"],
                              _matrices(results[1].params)["fc_w"])
    back = _pipe(tmp_path).run(resume=True)
    for r, b in zip(results, back):
        for k, v in _matrices(r.params).items():
            assert b.params[k].dtype == torch.float32
            assert b.params[k].device == torch.device("cpu")
            np.testing.assert_array_equal(_np(b.params[k]), v)
    for k, v in base_before.items():
        np.testing.assert_array_equal(_np(results[0].params[k]), v)


# ----------------------------------------------------- CLI and example


def test_cli_runs_on_the_cpu_and_resumes(tmp_path, caplog):
    argv = ["--steps", "2", "--batch", "2", "--hidden-base", "16",
            "--hidden-pruned", "8", "--frames", "4", "--num-classes", "48",
            "--device", "cpu", "--workdir", str(tmp_path / "w")]
    assert main(argv + ["--stop-after", "structured"]) == 0
    assert main(argv + ["--resume", "--artifact", str(tmp_path / "a")]) == 0
    manifest = (tmp_path / "w" / "pipeline.json").read_text()
    assert all(n in manifest for n in ("baseline", "structured",
                                       "unstructured", "qat4"))
    art = j_artifact.load_artifact(tmp_path / "a")
    assert art.cfg.hidden_dim == 8 and art.packed is not None


def test_entry_points_need_a_gpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would train")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--steps", "1", "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="is_available"):
        _pipe(None, device="cuda")
    example = _example()
    with pytest.raises(RuntimeError, match="is_available"):
        example.main(["--steps", "1", "--out", str(tmp_path / "o")])
    assert not (tmp_path / "stages").exists()


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_rsnn_timit_torch",
        ROOT / "examples" / "train_rsnn_timit_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_runs_on_the_cpu(tmp_path, monkeypatch):
    """The example's flow (recipe, Fig. 16 sweep, results.json) with
    ``--device cpu`` at a small size: the data and widths cut down."""
    example = _example()
    small = SpeechDataConfig(frames=4, num_classes=48)
    monkeypatch.setattr(example, "SpeechDataConfig", lambda: small)
    monkeypatch.setattr(example, "run_pipeline", lambda **kw: run_pipeline(
        hidden_base=16, hidden_pruned=8, data_cfg=small, **kw))
    out = tmp_path / "out"
    assert example.main(["--steps", "2", "--batch", "2", "--device", "cpu",
                         "--out", str(out), "--workdir",
                         str(tmp_path / "w"), "--artifact",
                         str(tmp_path / "a")]) == 0
    import json

    payload = json.loads((out / "results.json").read_text())
    assert [p["name"] for p in payload] == ["baseline", "structured",
                                            "unstructured", "qat4"]
    assert [s["time_steps"] for s in payload[-1]["ts_sweep"]] == [1, 2, 4]
    assert artifact.load_artifact(tmp_path / "a").packed is not None


def test_training_imports_leave_jax_and_reference_out():
    code = ("import sys, repro_torch.training.rsnn_pipeline, "
            "repro_torch.training.optimizer, "
            "repro_torch.checkpoint.checkpointer, repro_torch.core.temporal; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
