"""repro_torch's ``fused``/``fused_spike`` backends (K6/K7 ``megastep``)
vs the reference's on the CPU, served: the second half of
``tests/test_torch_fused.py``, whose tolerances and helpers it shares.

Teacher-forced frames of both backends over the small and the PRUNED
artifact, with the CSC and the dense int4 readout; a v1 ``StreamLoop``
of each against the reference's (sids, logits, counters); the trains
handed to ``megastep`` 0/1; and a 3-frame ``_chunk_step`` bit-equal to
three ``_frame_step`` calls in the port (one mega-step call against
three) and within the tolerances of the reference's.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import stream as S
from repro_torch.kernels import ops
from repro_torch.serving import stream as TS
from test_torch_fused import FUSED
from test_torch_spike import _close, _engines, assert_frames_match
from test_torch_stream import pruned_path, small_path  # noqa: F401


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


@pytest.mark.parametrize("backend", FUSED)
@pytest.mark.parametrize("sparse_fc", [True, False])
def test_fused_backends_pass_binary_trains(small_path, small_cfg,
                                           monkeypatch, backend, sparse_fc):
    """K6/K7 keep the spike trains as bits and read a nonzero entry as 1,
    so ``megastep`` is defined on 0/1 trains only: over a served
    StreamLoop (fresh slots, refills, an idle slot) every train and last
    spike the fused backends hand it is 0/1."""
    port = _engines(small_path, backend, sparse_fc=sparse_fc)[1]
    seen = []
    real = ops.megastep

    def spy(*a, **k):
        seen.append(torch.cat([t.reshape(-1)
                               for t in (a[1], a[3], a[4], a[6])]))
        return real(*a, **k)

    monkeypatch.setattr(ops, "megastep", spy)
    rng = np.random.default_rng(9)
    loop = TS.StreamLoop(port, batch_slots=2, pipeline_depth=0)
    for t in (5, 3, 6):
        loop.submit(rng.normal(size=(t, small_cfg.input_dim))
                    .astype(np.float32) * 3.0)
    loop.run()
    values = torch.cat(seen)
    assert len(seen) >= 6 and values.any()
    assert bool(((values == 0) | (values == 1)).all())


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
