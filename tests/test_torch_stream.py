"""repro_torch's serving path vs the reference's, on the CPU.

One artifact, two engines: the reference ``CompiledRSNN`` (Pallas kernels
in interpret mode for ``pallas``/``sparse``) and the port's on
``device="cpu"`` (the kernels' plain versions).  Frames are
teacher-forced — each frame starts both engines from the reference's state
— and compared for logits, state and packed counters.  The ``pallas`` and
``sparse`` logits are bit-equal (integer int4 sums, scaled once); the
recurrent sums are order-dependent, so u agrees within ``U_TOL``; ``ref``
logits use a dequantized-weight order and agree within ``LOGIT_TOL``.
These seeds put no membrane potential within rounding of a threshold, so
spikes and counters agree exactly.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifact as j_artifact
from repro.core import rsnn, sparse
from repro.core.compression import CompressionConfig, init_compression
from repro.core.rsnn import RSNNConfig
from repro.serving import stream as S
from repro_torch.core.lif import LIFState
from repro_torch.core.rsnn import RSNNState
from repro_torch.serving import stream as TS

ROOT = Path(__file__).resolve().parents[1]
U_TOL = 1e-5
LOGIT_TOL = 1e-5  # ref backend: x @ (q * s) vs (x @ q) * s rounding
BACKENDS = ["ref", "pallas", "sparse"]


@pytest.fixture(scope="module")
def small_path(tmp_path_factory):
    """One reference-written int4 artifact at ``small_cfg``'s widths."""
    cfg = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
    tmp_path = tmp_path_factory.mktemp("small")
    params = rsnn.init_params(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, cfg.input_dim)), jnp.float32)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    packed = sparse.pack_model(params, cfg, ccfg,
                               init_compression(params, ccfg))
    return j_artifact.save_artifact(
        tmp_path / "small", cfg=cfg, packed=packed, ccfg=ccfg,
        input_scale=S.calibrate_input_scale(x, cfg.input_bits))


@pytest.fixture(scope="module")
def pruned_path(tmp_path_factory):
    """chip_smoke.py's seeded PRUNED artifact."""
    tmp_path = tmp_path_factory.mktemp("pruned")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs.write_artifact(tmp_path / "pruned", 0, cs.utterances(0, 8))


def _to_torch(state: S.RSNNState) -> RSNNState:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return RSNNState(h0=t(state.h0), h1=t(state.h1),
                     lif0=LIFState(t(state.lif0.u), t(state.lif0.spike)),
                     lif1=LIFState(t(state.lif1.u), t(state.lif1.spike)))


def _assert_frame(port, ref, backend):
    (sp, lp, ap), (sj, lj, aj) = port, ref
    for a, b in ((sp.h0, sj.h0), (sp.h1, sj.h1),
                 (sp.lif0.spike, sj.lif0.spike),
                 (sp.lif1.spike, sj.lif1.spike)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((sp.lif0.u, sj.lif0.u), (sp.lif1.u, sj.lif1.u)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=U_TOL,
                                   atol=U_TOL)
    if backend == "ref":
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    else:
        np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("width", ["small", "pruned"])
def test_frames_teacher_forced_equal_reference(small_path, pruned_path,
                                               width, backend):
    path = small_path if width == "small" else pruned_path
    ref = S.CompiledRSNN.from_artifact(path, backend=backend)
    port = TS.CompiledRSNN.from_artifact(path, backend=backend, device="cpu")
    cfg = ref.cfg
    b, frames = 4, 3
    rng = np.random.default_rng(21)
    x = rng.normal(size=(frames, b, cfg.input_dim)).astype(np.float32)
    active = np.array([True, True, False, True])
    state = ref.init_state(b)
    for t in range(frames):
        xq_j = ref.quantize_features(jnp.asarray(x[t]))
        xq_p = port.quantize_features(x[t])
        np.testing.assert_array_equal(xq_p.numpy(), np.asarray(xq_j))
        out_j = ref.step_masked(state, xq_j, jnp.asarray(active))
        out_p = port.step_masked(_to_torch(state), xq_p,
                                 torch.from_numpy(active))
        _assert_frame(out_p, out_j, backend)
        state = out_j[0]
    assert float(np.asarray(state.h1).mean()) > 0.0  # the layers fire


@pytest.mark.parametrize("backend", BACKENDS + ["spike", "delta"])
def test_streamloop_matches_reference_loop(small_path, small_cfg, backend):
    """Per-request logits, refill order, measured sparsity and MMAC/s
    against the reference's synchronous loop; the same deterministic clock
    stamps both loops' request lifecycles.  ``spike``/``delta`` logits sum
    dequantized float32 weights in another order: within ``LOGIT_TOL``."""
    path = small_path
    rng = np.random.default_rng(5)
    utts = [rng.normal(size=(t, small_cfg.input_dim)).astype(np.float32)
            for t in (7, 10, 4, 0, 6, 3)]
    runs = []
    for eng, loop_cls in (
            (S.CompiledRSNN.from_artifact(path, backend=backend),
             S.StreamLoop),
            (TS.CompiledRSNN.from_artifact(path, backend=backend,
                                           device="cpu"), TS.StreamLoop)):
        loop = loop_cls(eng, batch_slots=2, pipeline_depth=0)
        ticks = iter(range(10_000))
        loop.clock = lambda: float(next(ticks))
        for u in utts:
            loop.submit(u)
        done = loop.run()
        runs.append((loop, done))
    (lj, dj), (lp, dp) = runs
    assert [r.sid for r in lp.finished] == [r.sid for r in lj.finished]
    assert [(r.t_start, r.t_done) for r in dp] == \
        [(r.t_start, r.t_done) for r in dj]
    assert (lp.steps, lp.frames_served, lp.host_syncs) == \
        (lj.steps, lj.frames_served, lj.host_syncs)
    assert dataclasses.asdict(lp.sparsity_profile()) == \
        dataclasses.asdict(lj.sparsity_profile())
    assert lp.mmac_per_second() == lj.mmac_per_second()
    for a, b in zip(dp, dj):
        assert a.stacked_logits().shape == b.stacked_logits().shape
        if backend in ("ref", "spike", "delta"):
            np.testing.assert_allclose(a.stacked_logits(), b.stacked_logits(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        else:
            np.testing.assert_array_equal(a.stacked_logits(),
                                          b.stacked_logits())


def test_entry_points_default_to_cuda_and_raise_without_it(
        small_path, monkeypatch):
    path = small_path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TS.CompiledRSNN.from_artifact(path)
    with pytest.raises(RuntimeError, match="is_available"):
        TS.resolve_device("cuda")
    assert TS.resolve_device("cpu") == torch.device("cpu")


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, repro_torch, repro_torch.serving.stream, "
            "repro_torch.core.artifact, repro_torch.core.complexity, "
            "repro_torch.kernels.ops, repro_torch.kernels.spike_broadcast, "
            "repro_torch.kernels.delta_step; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_config_and_loop_validation(small_path, small_cfg):
    with pytest.raises(ValueError, match="unknown backend"):
        TS.EngineConfig(backend="no_such_backend")
    assert TS.EngineConfig(backend="sparse", precision="int4").wants_sparse_fc
    eng = TS.CompiledRSNN.from_artifact(small_path,
                                        backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="ring_frames must be >= 1"):
        TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2, ring_frames=0)
    with pytest.raises(ValueError, match="multiple of"):
        TS.StreamLoop(eng, batch_slots=2, pipeline_depth=1, ring_frames=6,
                      chunk_frames=4)
    with pytest.raises(ValueError, match="pipeline_depth"):
        TS.StreamLoop(eng, batch_slots=2, pipeline_depth=-1)
    loop = TS.StreamLoop(eng, batch_slots=2)
    with pytest.raises(ValueError, match="input_dim"):
        loop.submit(np.zeros((3, small_cfg.input_dim + 1), np.float32))


def test_reset_slot_zeroes_one_slot_only():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    st = RSNNState(h0=r(2, 3, 4), h1=r(2, 3, 4),
                   lif0=LIFState(r(3, 4), r(3, 4)),
                   lif1=LIFState(r(3, 4), r(3, 4)))
    out = TS.reset_slot(st, 1)
    for a, b, dim in ((out.h0, st.h0, 1), (out.h1, st.h1, 1),
                      (out.lif0.u, st.lif0.u, 0),
                      (out.lif1.spike, st.lif1.spike, 0)):
        assert not a.select(dim, 1).any()
        keep = [i for i in range(3) if i != 1]
        assert torch.equal(a.index_select(dim, torch.tensor(keep)),
                           b.index_select(dim, torch.tensor(keep)))
        assert b.select(dim, 1).all()  # the input state is untouched
