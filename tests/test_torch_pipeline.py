"""repro_torch's pipelined (v2) and chunked slot loop, on the CPU.

Two reference-written artifacts at small widths (int4 with a 40%-pruned
CSC FC, and float) serve seeded numpy utterances through the port's
``StreamLoop`` in every contract: v2 at depths 1-3, chunks of 2 and 4
(v1 and v2), small rings that force watermark flushes, and without the
counter sink.  Within the port every run's logits are bit-equal to the
port's v1 run: the CPU runs each kernel's plain version, which is
deterministic, so no backend needs a tolerance here.  Against the
reference's ``StreamLoop`` at the same depth, chunk and ring, with the same
tick clock, the schedule, the lifecycle stamps, the counters, the measured
sparsity and MMAC/s are equal; logits as in ``test_torch_stream.py``
(``pallas`` bit-equal, ``ref`` within ``LOGIT_TOL``).  The reference's
pipeline and chunk edge cases run as cases of one test.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import dataclasses

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
from repro_torch.kernels import ops as kernel_ops
from repro_torch.serving import backends as TB
from repro_torch.serving import stream as TS

CFG = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
LOGIT_TOL = 1e-5  # ref backend: x @ (q * s) vs (x @ q) * s rounding
# lengths with ragged tails at chunks of 2 and 4, a 1-frame stream, an
# empty one and streams longer than the small rings (watermark flushes)
LENS = (5, 1, 9, 0, 3, 7, 4, 11, 2)
# (backend, delta_threshold, artifact)
ENGINES = [(b, 0.0, "int4") for b in
           ("ref", "pallas", "sparse", "spike", "delta", "fused",
            "fused_spike")] + [("delta", 2.0, "int4")] + [
    (b, 0.0, "float") for b in
    ("ref", "pallas", "spike", "delta", "fused", "fused_spike")]
# loop contracts held against the port's v1 loop, bit for bit
LOOPS = [dict(pipeline_depth=1), dict(pipeline_depth=2),
         dict(pipeline_depth=3), dict(pipeline_depth=2, ring_frames=4),
         dict(pipeline_depth=3, ring_frames=8),
         dict(pipeline_depth=0, chunk_frames=2),
         dict(pipeline_depth=0, chunk_frames=4),
         dict(pipeline_depth=2, chunk_frames=2, ring_frames=4),
         dict(pipeline_depth=1, chunk_frames=4, ring_frames=8),
         dict(pipeline_depth=2, chunk_frames=4, ring_frames=4),
         dict(pipeline_depth=2, chunk_frames=2, ring_frames=8,
              track_sparsity=False),
         dict(pipeline_depth=0, track_sparsity=False),
         dict(pipeline_depth=2, aot_warmup=False)]
# loop contracts held against the reference's loop
REF_LOOPS = [dict(pipeline_depth=2), dict(pipeline_depth=1, ring_frames=4),
             dict(pipeline_depth=3, ring_frames=8),
             dict(pipeline_depth=0, chunk_frames=2),
             dict(pipeline_depth=2, chunk_frames=4, ring_frames=8),
             dict(pipeline_depth=2, chunk_frames=2, ring_frames=4,
                  track_sparsity=False)]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Reference-written artifacts at ``CFG``'s widths: int4 (the
    ``small_path`` of ``test_torch_stream.py``) and float."""
    tmp = tmp_path_factory.mktemp("pipeline")
    params = rsnn.init_params(jax.random.PRNGKey(0), CFG)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, CFG.input_dim)), jnp.float32)
    scale = S.calibrate_input_scale(x, CFG.input_bits)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    packed = sparse.pack_model(params, CFG, ccfg,
                               init_compression(params, ccfg))
    return {"int4": j_artifact.save_artifact(
                tmp / "int4", cfg=CFG, packed=packed, ccfg=ccfg,
                input_scale=scale),
            "float": j_artifact.save_artifact(
                tmp / "float", cfg=CFG, params=params, input_scale=scale)}


def _utts(lens=LENS, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(t, CFG.input_dim)).astype(np.float32)
            for t in lens]


def _port(paths, backend="pallas", threshold=0.0, art="int4"):
    if threshold:
        eng = TS.CompiledRSNN.from_artifact(paths[art], device="cpu")
        return TS.CompiledRSNN.from_artifact(
            paths[art], dataclasses.replace(
                eng.engine, backend=backend, delta_threshold=threshold),
            device="cpu")
    return TS.CompiledRSNN.from_artifact(paths[art], backend=backend,
                                         device="cpu")


def _serve(loop, utts):
    sids = [loop.submit(u) for u in utts]
    done = {r.sid: r for r in loop.run()}
    return [done[s].stacked_logits() for s in sids]


def _tick(loop):
    ticks = iter(range(100_000))
    loop.clock = lambda: float(next(ticks))
    return loop


@pytest.mark.parametrize("backend,threshold,art", ENGINES)
def test_v2_and_chunks_bit_equal_to_v1(paths, backend, threshold, art):
    eng = _port(paths, backend, threshold, art)
    utts = _utts()
    v1 = TS.StreamLoop(eng, batch_slots=3, pipeline_depth=0)
    base = _serve(v1, utts)
    prof = v1.sparsity_profile()
    for kw in LOOPS:
        loop = TS.StreamLoop(eng, batch_slots=3, **kw)
        got = _serve(loop, utts)
        for a, b in zip(base, got):
            np.testing.assert_array_equal(a, b, err_msg=str(kw))
        assert loop.frames_served == v1.frames_served == sum(LENS)
        assert loop.pending_steps == 0
        if loop.track_sparsity:
            assert loop.sparsity_profile() == prof, kw
        if loop.chunk_frames > 1:
            assert loop.dispatches < v1.dispatches
        else:
            assert loop.steps == loop.dispatches == v1.steps


@pytest.mark.parametrize("kw", REF_LOOPS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_loop_matches_reference_loop(paths, backend, kw):
    """Schedule, stamps, counters, measured sparsity and MMAC/s equal to
    the reference's loop at the same depth, chunk and ring."""
    utts = _utts()
    loops = []
    for eng, cls in ((S.CompiledRSNN.from_artifact(paths["int4"],
                                                   backend=backend),
                      S.StreamLoop),
                     (_port(paths, backend), TS.StreamLoop)):
        loop = _tick(cls(eng, batch_slots=3, **kw))
        for u in utts:
            loop.submit(u)
        loops.append((loop, loop.run()))
    (lj, dj), (lp, dp) = loops
    assert [r.sid for r in lp.finished] == [r.sid for r in lj.finished]
    assert [(r.t_submit, r.t_start, r.t_done, r.t_harvest) for r in dp] \
        == [(r.t_submit, r.t_start, r.t_done, r.t_harvest) for r in dj]
    assert (lp.steps, lp.dispatches, lp.frames_served, lp.host_syncs) == \
        (lj.steps, lj.dispatches, lj.frames_served, lj.host_syncs)
    if kw.get("track_sparsity", True):
        assert dataclasses.asdict(lp.sparsity_profile()) == \
            dataclasses.asdict(lj.sparsity_profile())
        assert lp.mmac_per_second() == lj.mmac_per_second()
        assert lp.mmac_per_second(0.5) == lj.mmac_per_second(0.5)
    else:
        assert lp.counters is None and lj.counters is None
    for a, b in zip(dp, dj):
        assert a.stacked_logits().shape == b.stacked_logits().shape
        if backend == "ref":
            np.testing.assert_allclose(a.stacked_logits(), b.stacked_logits(),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        else:
            np.testing.assert_array_equal(a.stacked_logits(),
                                          b.stacked_logits())


# ------------------------------------------------------------- edge cases


def _complete_in_flight(eng):
    """A 2-frame stream completes while depth 3 still holds both of its
    steps in flight; its logits arrive when the last one retires."""
    utts = _utts((2, 9, 8), seed=7)
    want = _serve(TS.StreamLoop(eng, batch_slots=2, pipeline_depth=0), utts)
    pipe = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=3)
    for u in utts:
        pipe.submit(u)
    assert pipe.step_once() and pipe.step_once()
    assert pipe.pending_steps == 2
    short = next(r for r in pipe.finished if r.sid == 0)
    assert short.done and len(short.pending) == 1 and short.logits == []
    assert short.t_harvest is None
    done = pipe.run()
    for a, b in zip(want, [r.stacked_logits() for r in done]):
        np.testing.assert_array_equal(a, b)


def _refill_unharvested(eng):
    """Back-to-back streams through one slot at depth 2: the next stream
    overwrites ring rows whose harvest has not retired yet.  The harvest
    copies the rows at completion, so both streams stay exact."""
    utts = _utts((4, 6, 3), seed=7)
    want = _serve(TS.StreamLoop(eng, batch_slots=1, pipeline_depth=0), utts)
    got = _serve(TS.StreamLoop(eng, batch_slots=1, pipeline_depth=2), utts)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def _ring_wrap(eng):
    """A stream longer than the ring crosses in watermark blocks and
    equals ``CompiledRSNN.run`` over it alone."""
    utts = _utts((11, 5), seed=7)
    pipe = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2, ring_frames=4)
    for u, got in zip(utts, _serve(pipe, utts)):
        solo, _, _ = eng.run(u[None])
        np.testing.assert_array_equal(got, solo[0].numpy())
    long = next(r for r in pipe.finished if len(r.frames) == 11)
    assert len(long.logits) == 11
    assert pipe.host_syncs == 3 + 2 + 1  # blocks of 4 (11, 5); counters


def _flush_depth2(eng):
    """``flush`` retires every in-flight step and folds the accumulator,
    mid-serve or at the end, and is idempotent."""
    utts = _utts((5, 9, 3, 7, 6), seed=7)
    pipe = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2)
    for u in utts:
        pipe.submit(u)
    for _ in range(3):
        pipe.step_once()
    assert pipe.pending_steps == 1  # depth 2: one step stays in flight
    pipe.flush()
    assert pipe.pending_steps == 0
    assert pipe.counters.frames == 6.0  # 3 steps x 2 active slots
    pipe.flush()
    assert pipe.counters.frames == 6.0
    done = pipe.run()
    assert pipe.counters.frames == float(sum(len(u) for u in utts))
    assert [r.sid for r in done] == list(range(len(utts)))


def _empty_utterance(eng):
    pipe = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2)
    a, b = _utts((4, 5), seed=7)
    pipe.submit(a)
    empty = pipe.submit(np.zeros((0, CFG.input_dim), np.float32))
    pipe.submit(b)
    done = pipe.run()
    assert [r.sid for r in done] == [0, empty, 2]
    assert done[1].logits == [] and done[1].done and not done[1].pending
    assert done[1].stacked_logits().shape == (0, CFG.fc_dim)


def _counter_gating(eng):
    """``track_sparsity=False``: no counters and no counter fetch; the
    only host transfers are the harvests (v2) or the logits (v1)."""
    utts = _utts((5, 9, 3, 7, 6), seed=7)
    quiet = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2,
                          track_sparsity=False)
    assert len(_serve(quiet, utts)) == len(utts)
    assert quiet.counters is None and quiet._aux_acc is None
    assert quiet.host_syncs == len(utts)  # one harvest a stream
    with pytest.raises(ValueError, match="track_sparsity"):
        quiet.sparsity_profile()
    with pytest.raises(ValueError, match="track_sparsity"):
        quiet.mmac_per_second()
    sync = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=0,
                         track_sparsity=False)
    _serve(sync, utts)
    assert sync.host_syncs == sync.steps  # logit fetches only


def _chunk_validation(eng):
    with pytest.raises(ValueError, match="chunk_frames must be >= 1"):
        TS.StreamLoop(eng, chunk_frames=0)
    with pytest.raises(ValueError, match="multiple of"):
        TS.StreamLoop(eng, pipeline_depth=2, ring_frames=6, chunk_frames=4)
    # v1 has no ring, so any chunk is valid
    TS.StreamLoop(eng, pipeline_depth=0, ring_frames=6, chunk_frames=4)


def _idle_tail_dropped(eng):
    """A stream that completes in the first sub-step of its last chunk
    idles for three more: those writes land in the ring's spare row, not
    on the completed stream's rows, which the harvest reads."""
    utts = _utts((5, 13), seed=7)
    want = _serve(TS.StreamLoop(eng, batch_slots=2, pipeline_depth=0), utts)
    pipe = TS.StreamLoop(eng, batch_slots=2, pipeline_depth=2, ring_frames=8,
                         chunk_frames=4)
    assert pipe.ring.shape == (2, 8, CFG.fc_dim)
    assert pipe._ring.shape == (2, 9, CFG.fc_dim)
    for u in utts:
        pipe.submit(u)
    pipe._ring[:, 8] = 7.0  # a sentinel no logit row equals
    pipe.step_once()
    assert (pipe._ring[:, 8] == 7.0).all()  # every sub-step was live
    pipe.step_once()  # stream 0: frame 5 live, three idle sub-steps
    assert not (pipe._ring[0, 8] == 7.0).any()  # the idle writes' row
    assert (pipe._ring[1, 8] == 7.0).all()
    np.testing.assert_array_equal(pipe._ring[0, 4].numpy(), want[0][4])
    for a, b in zip(want, [r.stacked_logits() for r in pipe.run()]):
        np.testing.assert_array_equal(a, b)


EDGE_CASES = {"complete_in_flight": _complete_in_flight,
              "refill_unharvested": _refill_unharvested,
              "ring_wrap": _ring_wrap, "flush_depth2": _flush_depth2,
              "empty_utterance": _empty_utterance,
              "counter_gating": _counter_gating,
              "chunk_validation": _chunk_validation,
              "idle_tail_dropped": _idle_tail_dropped}


@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("art", ["int4", "float"])
def test_pipeline_edge_case(paths, art, case):
    EDGE_CASES[case](_port(paths, "pallas", art=art))


# ------------------------------------------------------- engine and state


@pytest.mark.parametrize("backend", ["ref", "pallas", "delta"])
def test_run_matches_reference_run(paths, backend):
    """``CompiledRSNN.run`` over two calls that carry the state: logits,
    state and per-frame counters against the reference's ``run``."""
    ref = S.CompiledRSNN.from_artifact(paths["int4"], backend=backend)
    port = _port(paths, backend)
    x = np.random.default_rng(4).normal(
        size=(3, 10, CFG.input_dim)).astype(np.float32)
    sj = sp = None
    for part in (x[:, :6], x[:, 6:]):
        lj, sj, aj = ref.run(jnp.asarray(part), sj)
        lp, sp, ap = port.run(part, sp)
        assert lp.shape == (3, part.shape[1], CFG.fc_dim)
        if backend == "pallas":
            np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
        else:
            np.testing.assert_allclose(lp.numpy(), np.asarray(lj),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert sorted(ap) == sorted(aj)
        for k in ap:
            np.testing.assert_array_equal(ap[k].numpy(), np.asarray(aj[k]))
        for a, b in zip(TS._leaves(sp), jax.tree.leaves(sj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_step_ring_updates_in_place(paths):
    """``step_ring`` writes the state, the ring row and the counter add
    into the tensors it is given, and equals ``step_masked``."""
    eng = _port(paths, "pallas")
    b = 3
    state, ring = eng.init_state(b), torch.zeros((b, 4, CFG.fc_dim))
    acc = torch.zeros(2 * CFG.num_ts + 4)
    ptrs = [t.data_ptr() for t in (*TS._leaves(state), ring, acc)]
    x = torch.from_numpy(_utts((b,), seed=5)[0])
    ctrl = torch.tensor([[1, 0, 1], [2, 0, 3]], dtype=torch.int32)
    want_state, logits, vec = eng.step_masked(
        eng.init_state(b), eng.quantize_features(x), ctrl[0])
    out = eng.step_ring(state, x, ctrl, ring, acc)
    assert [t.data_ptr() for t in (*TS._leaves(out[0]), out[1], out[2])] \
        == ptrs
    for a, w in zip(TS._leaves(state), TS._leaves(want_state)):
        assert torch.equal(a, w)
    for i, row in enumerate(ctrl[1].tolist()):
        assert torch.equal(ring[i, row], logits[i])
    assert torch.equal(acc, vec)


@pytest.mark.parametrize("delta", [False, True])
def test_reset_slot_in_place_keeps_storage(delta):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(s, generator=g) + 0.5  # noqa: E731
    st = RSNNState(h0=r(2, 3, 4), h1=r(2, 3, 4),
                   lif0=LIFState(r(3, 4), r(3, 4)),
                   lif1=LIFState(r(3, 4), r(3, 4)))
    if delta:
        st = TS.DeltaRSNNState(rsnn=st, x_prev=r(3, 5), pre=r(3, 4))
    before = [t.clone() for t in TS._leaves(st)]
    ptrs = [t.data_ptr() for t in TS._leaves(st)]
    TS.reset_slot_(st, 1)
    assert [t.data_ptr() for t in TS._leaves(st)] == ptrs
    for t, old in zip(TS._leaves(st), before):
        dim = 1 if t.dim() == 3 else 0  # h0/h1 carry TS first
        assert not t.select(dim, 1).any()
        keep = torch.tensor([0, 2])
        assert torch.equal(t.index_select(dim, keep),
                           old.index_select(dim, keep))


def test_capture_count_moves_at_construction_only(paths):
    """One keyed entry a loop at construction (graphs bind their loop's
    buffers, so a second loop of the same signature builds its own), none
    with ``aot_warmup=False``, and none during a steady-state serve."""
    eng = _port(paths, "pallas")
    assert eng.capture_count == 0
    kw = dict(batch_slots=2, pipeline_depth=2, ring_frames=8, chunk_frames=2)
    loop = TS.StreamLoop(eng, **kw)
    assert eng.capture_count == 1
    assert loop._key == ("v2-chunk", 2, 2, 8, True)
    TS.StreamLoop(eng, **kw)
    assert eng.capture_count == 2
    TS.StreamLoop(eng, **kw, aot_warmup=False)
    assert eng.capture_count == 2
    _serve(loop, _utts((5, 9, 3, 7, 2, 8), seed=3))
    loop.sparsity_profile()
    assert eng.capture_count == 2
    keys = {TS.StreamLoop(eng, batch_slots=2, pipeline_depth=d,
                          chunk_frames=c, ring_frames=8,
                          track_sparsity=t)._key[0]
            for d in (0, 2) for c in (1, 4) for t in (True, False)}
    assert keys == {"v1", "v1-chunk", "v2", "v2-chunk", "v2-quiet",
                    "v2-chunk-quiet"}


def test_launch_counts_credit_and_restore():
    saved = kernel_ops.launch_counts()
    try:
        kernel_ops.set_launch_counts(dict.fromkeys(saved, 0))
        kernel_ops.add_launch_counts({"megastep": 2, "rsnn_cell": 3})
        kernel_ops.add_launch_counts({"megastep": 1})
        got = kernel_ops.launch_counts()
        assert got == dict(dict.fromkeys(saved, 0), megastep=3, rsnn_cell=3)
    finally:
        kernel_ops.set_launch_counts(saved)
    assert kernel_ops.launch_counts() == saved


def test_unregister_backend(paths):
    @TB.register("throwaway_test_backend")
    def _build(ctx):
        return TB.resolve("ref", ctx)._replace(name="throwaway_test_backend")

    try:
        assert "throwaway_test_backend" in TB.available()
        eng = _port(paths, "throwaway_test_backend")
        assert eng.ops.name == "throwaway_test_backend"
    finally:
        TB.unregister("throwaway_test_backend")
    assert "throwaway_test_backend" not in TB.available()
    with pytest.raises(ValueError, match="unknown backend"):
        TB.resolve("throwaway_test_backend", eng._ctx)
    TB.unregister("throwaway_test_backend")  # a missing name is a no-op
