"""repro_torch's mega-step (K6 ``megastep``, K7 ``megastep(spike=True)``)
and its ``fused``/``fused_spike`` backends vs the reference's, on the CPU.

The same seeded numpy inputs go through ``repro.kernels`` (the Pallas
mega-step in interpret mode, and the reference's ``megastep_ref``) and
``repro_torch.kernels`` on CPU tensors (``ref.megastep_ref``, the plain
version the CUDA kernel is held against on the card).  Tolerances:

* spikes and the four counters exact (these seeds put no membrane
  potential within rounding of a threshold);
* ``u`` within ``|d| <= 1e-5 * (1 + |y|)`` (``_close``): float32 sums of
  dequantized weights in another order (and, in spike mode, over the
  event lists);
* logits bit-equal with the CSC readout (integer sums, one scale in both
  packages); with ``dense_int4`` within that tolerance: the reference sums
  dequantized float32 weights where the port sums integers and scales
  once;
* inside the port: a 3-frame ``_chunk_step`` equals three ``_frame_step``
  calls bit for bit, and the plain K7 equals the plain K6 in spikes,
  counters and logits.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.serving import stream as S
from repro_torch.core.layouts import base as layout_base
from repro_torch.core.layouts import csc as t_csc
from repro_torch.core.layouts import dense as t_dense
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import megastep as mega_kernel
from repro_torch.serving import backends
from repro_torch.serving import stream as TS
from test_torch_spike import _close, _engines, assert_frames_match
from test_torch_stream import ROOT, pruned_path, small_path  # noqa: F401

# (input_dim, hidden, fc_dim, batch): small_cfg's widths and PRUNED's
WIDTHS = {"small": (8, 16, 12, 3), "pruned": (40, 128, 1920, 4)}
FUSED = ["fused", "fused_spike"]
STATE = ("s0", "u0", "s1", "u1")
OUTS = STATE + ("logits", "spikes_l0", "spikes_l1", "union_l1",
                "input_one_bits")


def _operands(width: str, ts: int, fc_mode: str, frames: int = 3,
              seed: int = 41) -> tuple:
    """Seeded numpy operands of ``megastep``: 8-bit integer frames,
    random 0/1 trains and LIF carries, int4 layer weights, and the FC as
    dense nibbles or padded CSC."""
    d, h, n, b = WIDTHS[width]
    rng = np.random.default_rng(seed)

    def spikes(*shape):
        return (rng.random(shape) < 0.3).astype(np.float32)

    def scale(m, lo, hi):
        return rng.uniform(lo, hi, (1, m)).astype(np.float32)

    def packed(k, m):
        return rng.integers(-128, 128, (k // 2, m)).astype(np.int8)

    x = np.clip(np.round(rng.normal(size=(frames, b, d)) * 30), -127,
                127).astype(np.float32)
    state = (spikes(ts, b, h), rng.normal(size=(b, h)).astype(np.float32),
             spikes(b, h), spikes(ts, b, h),
             rng.normal(size=(b, h)).astype(np.float32), spikes(b, h))
    lif = tuple(a for _ in range(2) for a in (
        rng.choice([0.5, 0.75, 0.875], h).astype(np.float32),
        np.ones(h, np.float32)))
    wargs = (packed(d, h), scale(h, 0.002, 0.006), packed(h, h),
             scale(h, 0.02, 0.06), packed(h, h), scale(h, 0.1, 0.25),
             packed(h, h), scale(h, 0.02, 0.06))
    if fc_mode == "dense_int4":
        fcargs = (packed(h, n), scale(n, 0.01, 0.1))
    else:
        nnz = max(h // 2, 1)
        idx = np.sort(rng.permuted(np.tile(np.arange(h), (n, 1)), axis=1)
                      [:, :nnz].T, axis=0).astype(np.int32)
        val = rng.integers(-8, 8, (nnz, n)).astype(np.float32)
        val[-2:, ::3] = 0.0  # padded tails: (index 0, value 0)
        idx[-2:, ::3] = 0
        fcargs = (idx, val, scale(n, 0.01, 0.1))
    return (x, *state, *lif, wargs, fcargs)


def _to_jax(args):
    return tuple(tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
                 else jnp.asarray(a) for a in args)


def _to_port(args):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return tuple(tuple(map(t, a)) if isinstance(a, tuple) else t(a)
                 for a in args)


def _assert_outputs(port, want, exact_logits: bool):
    """Nine outputs: spikes and counters exact, u within ``_close``'s
    tolerance, logits exact or within it."""
    for name, p, w in zip(OUTS, port, want):
        p, w = p.numpy(), np.asarray(w)
        assert p.shape == w.shape, name
        if name in ("u0", "u1") or (name == "logits" and not exact_logits):
            _close(p, w)
        else:
            np.testing.assert_array_equal(p, w, err_msg=name)


# ------------------------------------------------------------ megastep_ref


@pytest.mark.parametrize("width,ts", [("small", 1), ("small", 2),
                                      ("pruned", 2)])
@pytest.mark.parametrize("fc_mode", ["dense_int4", "csc"])
@pytest.mark.parametrize("spike", [False, True])
def test_megastep_ref_matches_reference(width, ts, fc_mode, spike):
    """The port's plain K6/K7 over a 3-frame chunk against the
    reference's oracle and its Pallas mega-step in interpret mode (same
    ``spike`` mode); and K7's plain version against K6's."""
    args = _operands(width, ts, fc_mode)
    kw = dict(fc_mode=fc_mode, input_bits=8)
    got = ref.megastep_ref(*_to_port(args), **kw, spike=spike)
    exact = fc_mode == "csc"
    _assert_outputs(got, jref.megastep_ref(*_to_jax(args), precision="int4",
                                           **kw), exact)
    _assert_outputs(got, jops.megastep(*_to_jax(args), precision="int4",
                                       **kw, spike=spike), exact)
    other = ref.megastep_ref(*_to_port(args), **kw, spike=not spike)
    _assert_outputs(got, other, exact_logits=True)
    s1 = got[2].numpy()
    assert 0.05 < float(s1.mean()) < 0.95  # the layers fire, not always
    assert got[4].shape == (3, WIDTHS[width][3], WIDTHS[width][2])


def test_megastep_ref_refuses_other_fc_modes():
    """An FC mode no layout binds is refused by the plain version, the
    dispatch and the wrapper's operand check (``nm`` is served,
    ``tests/test_torch_nm.py``; ``dense_float`` with float weights,
    ``tests/test_torch_float.py``)."""
    args = _to_port(_operands("small", 2, "dense_int4"))
    with pytest.raises(ValueError, match="fc_mode"):
        ref.megastep_ref(*args, fc_mode="bogus", input_bits=8)
    with pytest.raises(ValueError, match="fc_mode"):
        ops.megastep(*args, fc_mode="sparse", input_bits=8)
    with pytest.raises(ValueError, match="fc_mode"):
        mega_kernel._fc_operands("bogus", args[-1], 16)


def test_cpu_tensor_runs_plain_version_without_launching():
    before = (mega_kernel.launches, mega_kernel.spike_launches)
    args = _to_port(_operands("small", 2, "csc"))
    for spike in (False, True):
        out = ops.megastep(*args, fc_mode="csc", input_bits=8, spike=spike)
        assert len(out) == 9
    assert (mega_kernel.launches, mega_kernel.spike_launches) == before
    assert _build._lib is None  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.megastep(*args, fc_mode="csc", input_bits=8)


# ----------------------------------------------------------- served frames


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("width", ["small", "pruned"])
@pytest.mark.parametrize("sparse_fc", [True, False])
def test_fused_frames_teacher_forced_match_reference(
        small_path, pruned_path, backend, width, sparse_fc):
    """``from_artifact(backend=...)`` on both sides, teacher-forced
    frames: the CSC readout bit-equal, the dense int4 one within
    ``_close``'s tolerance."""
    path = small_path if width == "small" else pruned_path
    ref_eng, port = _engines(path, backend, sparse_fc=sparse_fc)
    assert port.ops.name == backend and port.ops.megastep is not None
    assert_frames_match(ref_eng, port, exact_logits=sparse_fc)


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("sparse_fc", [True, False])
def test_fused_streamloop_matches_reference_loop(small_path, small_cfg,
                                                  backend, sparse_fc):
    """A v1 StreamLoop of each against the reference's: sids, logits and
    the summed counters (measured sparsity, MMAC/s)."""
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
            for t in (7, 10, 4, 0, 6, 3)]
    loops = []
    for eng, loop_cls in zip(_engines(small_path, backend,
                                      sparse_fc=sparse_fc),
                             (S.StreamLoop, TS.StreamLoop)):
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
        if sparse_fc:
            np.testing.assert_array_equal(a.stacked_logits(),
                                          b.stacked_logits())
        else:
            _close(a.stacked_logits(), b.stacked_logits())


# -------------------------------------------------------------- chunk step


@pytest.mark.parametrize("backend", FUSED + ["pallas", "delta"])
def test_chunk_step_equals_frame_steps(small_path, small_cfg, monkeypatch,
                                       backend):
    """``_chunk_step`` over F = 3 frames: bit-equal to three
    ``_frame_step`` calls in the port (one mega-step call against three
    for the ``fused`` tables), and against the reference's
    ``_chunk_step`` within the tolerances above."""
    ref_eng, port = _engines(small_path, backend, sparse_fc=True)
    b, frames = 4, 3
    rng = np.random.default_rng(17)
    x = rng.normal(size=(frames, b, small_cfg.input_dim)).astype(np.float32)
    xq = torch.stack([port.quantize_features(f) for f in x])
    calls = []
    real = ops.megastep
    monkeypatch.setattr(ops, "megastep",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    warm, _, _ = port._frame_step(port.init_state(b), xq[0] * 0.5)
    calls.clear()
    state_c, logits_c, aux_c = port._chunk_step(warm, xq)
    n_chunk = len(calls)
    state_f, logits_f, aux_f = warm, [], []
    for t in range(frames):
        state_f, lg, ax = port._frame_step(state_f, xq[t])
        logits_f.append(lg)
        aux_f.append(ax)
    fused = backend in FUSED
    assert (n_chunk, len(calls) - n_chunk) == ((1, frames) if fused
                                               else (0, 0))
    for a, c in zip(torch.utils._pytree.tree_leaves(state_c),
                    torch.utils._pytree.tree_leaves(state_f)):
        assert torch.equal(a, c)
    assert torch.equal(logits_c, torch.stack(logits_f))
    assert sorted(aux_c) == sorted(aux_f[0])
    for k in aux_c:
        assert torch.equal(aux_c[k], torch.stack([a[k] for a in aux_f])), k

    warm_j, _, _ = ref_eng._frame_step(ref_eng.init_state(b),
                                       jnp.asarray(xq[0].numpy() * 0.5))
    state_j, logits_j, aux_j = ref_eng._chunk_step(warm_j,
                                                   jnp.asarray(xq.numpy()))
    core_c, core_j = getattr(state_c, "rsnn", state_c), \
        getattr(state_j, "rsnn", state_j)
    for a, c in ((core_c.h0, core_j.h0), (core_c.h1, core_j.h1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    _close(core_c.lif0.u.numpy(), core_j.lif0.u)
    _close(core_c.lif1.u.numpy(), core_j.lif1.u)
    np.testing.assert_array_equal(logits_c.numpy(), np.asarray(logits_j))
    for k in aux_c:
        np.testing.assert_array_equal(aux_c[k].numpy(), np.asarray(aux_j[k]))


# ---------------------------------------------------------- table contract


@pytest.mark.parametrize("backend", FUSED)
def test_collapsed_entries_raise(small_path, backend):
    port = TS.CompiledRSNN.from_artifact(small_path, backend=backend,
                                         device="cpu")
    for op in ("rsnn_cell", "ff_matmul", "fc"):
        with pytest.raises(RuntimeError, match="one megastep launch"):
            getattr(port.ops, op)()
    assert port.ops.delta_gate is None


@pytest.mark.parametrize("backend", FUSED)
def test_fused_without_merged_spike_raises(small_path, backend):
    port = TS.CompiledRSNN.from_artifact(small_path, backend="pallas",
                                         device="cpu")
    ctx = dataclasses.replace(port._ctx, cfg=dataclasses.replace(
        port.cfg, merged_spike=False))
    with pytest.raises(ValueError, match="merged-spike"):
        backends.resolve(backend, ctx)
    backends.resolve("pallas", ctx)  # a per-ts readout backend serves it


def test_layout_megastep_fc_bindings(small_path):
    port = TS.CompiledRSNN.from_artifact(small_path, backend="pallas",
                                         device="cpu")
    qt, sc = port.packed.quant["fc_w"], port.packed.sparse["fc_w"]
    mode, operands, statics = t_dense.DENSE.megastep_fc(qt)
    assert (mode, statics) == ("dense_int4", {})
    assert operands[0] is qt.packed and operands[1] is qt.scale
    mode, operands, statics = t_csc.CSC.megastep_fc(sc)
    assert (mode, statics) == ("csc", {})
    assert all(a is b for a, b in zip(operands,
                                      (sc.indices, sc.values, sc.scale)))

    class Bare(layout_base.WeightLayout):
        name, tensor_type = "bare", tuple
        matmul = fc_kernel = unflatten = None

    with pytest.raises(NotImplementedError, match="mega-step"):
        Bare().megastep_fc(())


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch.kernels.megastep, "
            "repro_torch.serving.backends; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
