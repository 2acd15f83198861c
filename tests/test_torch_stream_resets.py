"""Slot resets inside the captured step (``reset_slots_``), on the CPU.

A fill flags its slot fresh in the next control word, and that step
zeroes the state of its fresh slots before it advances them; a finished
slot that is not refilled idles on its old state, masked.  Here:
``reset_slots_`` against ``reset_slot_`` of each flagged slot, bit for
bit; every stream's logits against the reference (``repro``) run over the
stream alone, in every contract of ``StreamLoop`` and of
``ShardedStreamLoop`` over two ``cpu`` shards, on a schedule where slots
finish while the queue is empty, idle on their old state for dispatches
and are refilled in the step in which another slot completes mid-chunk;
and that serving launches no per-slot reset.
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
from repro_torch.serving import sharded as SH
from repro_torch.serving import stream as TS

CFG = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
SLOTS = 4
# served first: slots 2 and 3 finish at once and slot 0 soon after, with
# the queue empty; the 13-frame stream in slot 1 runs on
FIRST = (6, 13, 3, 2)
# submitted once slot 1 is one frame short of a chunk's end (12 of 13):
# three of them fill the idle slots in the step in which slot 1 completes,
# mid-chunk at C = 4; the last takes slot 1 a step later.  Each opens on a
# silent frame, which the delta gate propagates nothing of, so that its
# first step reads the cached pre-activation a fill must zero
LATER = (5, 9, 7, 4)
CONTRACTS = {"v1": dict(pipeline_depth=0),
             "v1-chunk": dict(pipeline_depth=0, chunk_frames=4),
             "v2": dict(pipeline_depth=2),
             "v2-chunk": dict(pipeline_depth=2, chunk_frames=4),
             "v2-quiet": dict(pipeline_depth=2, track_sparsity=False),
             "v2-chunk-quiet": dict(pipeline_depth=2, chunk_frames=4,
                                    track_sparsity=False)}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    """A reference-written int4 artifact with a 40%-pruned CSC FC."""
    params = rsnn.init_params(jax.random.PRNGKey(0), CFG)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 10, CFG.input_dim)), jnp.float32)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    packed = sparse.pack_model(params, CFG, ccfg,
                               init_compression(params, ccfg))
    return j_artifact.save_artifact(
        tmp_path_factory.mktemp("resets") / "int4", cfg=CFG, packed=packed,
        ccfg=ccfg, input_scale=S.calibrate_input_scale(x, CFG.input_bits))


def utterances(lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, CFG.input_dim)).astype(np.float32)
            for n in lens]


FIRST_UTTS, LATER_UTTS = utterances(FIRST, 11), utterances(LATER, 12)
for _u in LATER_UTTS:
    _u[0] = 0.0


@pytest.fixture(scope="module")
def reference(path):
    """Each stream's logits from the reference's engine (``pallas``), run
    over the stream alone from a zero state."""
    eng = S.CompiledRSNN.from_artifact(path, backend="pallas")
    return [np.asarray(eng.run(jnp.asarray(u[None]))[0][0])
            for u in FIRST_UTTS + LATER_UTTS]


def make_loop(path, contract, sharded, backend="pallas", threshold=0.0):
    eng = TS.CompiledRSNN.from_artifact(path, backend=backend, device="cpu")
    if threshold:
        eng = TS.CompiledRSNN.from_artifact(path, dataclasses.replace(
            eng.engine, delta_threshold=threshold), device="cpu")
    kw = dict(CONTRACTS[contract], batch_slots=SLOTS, ring_frames=8)
    if sharded:
        return SH.ShardedStreamLoop(eng, devices=["cpu"] * 2, max_frames=16,
                                    **kw)
    return TS.StreamLoop(eng, **kw)


def serve(loop) -> list[np.ndarray]:
    """Serve ``FIRST``, then ``LATER`` once slot 1 reaches frame 12 with
    the other slots idle; returns every stream's logits in submit order."""
    sids = [loop.submit(u) for u in FIRST_UTTS]
    while loop.slot_pos[1] < 12:
        assert loop.step_once()
    assert not loop.queue
    assert [r is None for r in loop.slot_req] == [True, False, True, True]
    sids += [loop.submit(u) for u in LATER_UTTS]
    done = {r.sid: r for r in loop.run()}
    return [done[s].stacked_logits() for s in sids]


def _state(delta: bool):
    """A state of 5 slots with values of both signs, -0.0 among them."""
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        t = torch.randn(shape, generator=g)
        t[t.abs() < 0.3] = -0.0
        return t

    st = RSNNState(h0=r(2, 5, 4), h1=r(2, 5, 4),
                   lif0=LIFState(r(5, 4), r(5, 4)),
                   lif1=LIFState(r(5, 4), r(5, 4)))
    return TS.DeltaRSNNState(rsnn=st, x_prev=r(5, 3), pre=r(5, 4)) \
        if delta else st


@pytest.mark.parametrize("flags", [[0, 0, 0, 0, 0], [0, 1, 0, 0, 1],
                                   [1, 1, 1, 1, 1]],
                         ids=["none", "some", "all"])
@pytest.mark.parametrize("delta", [False, True],
                         ids=["RSNNState", "DeltaRSNNState"])
def test_reset_slots_equals_reset_slot_of_each_flagged_slot(delta, flags):
    want, got = _state(delta), _state(delta)
    for i, f in enumerate(flags):
        if f:
            TS.reset_slot_(want, i)
    ptrs = [t.data_ptr() for t in TS._leaves(got)]
    TS.reset_slots_(got, torch.tensor(flags, dtype=torch.int32))
    assert [t.data_ptr() for t in TS._leaves(got)] == ptrs
    for a, b in zip(TS._leaves(got), TS._leaves(want), strict=True):
        # the bits, so that a -0.0 where zero_ writes +0.0 would show
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_every_stream_equals_the_reference_alone(path, reference, contract,
                                                 sharded):
    loop = make_loop(path, contract, sharded)
    got = serve(loop)
    assert len(got) == len(reference)
    for a, b in zip(got, reference):
        np.testing.assert_array_equal(a, b)
    assert loop.resets == loop.finishes == len(FIRST) + len(LATER)


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_delta_state_is_reset_in_the_step(path, contract, sharded):
    """The ``delta`` backend's ``DeltaRSNNState`` (held input, cached
    pre-activation), at a threshold that holds some elements, so that an
    old occupant's held input would show: every stream equals the port's
    engine run over it alone."""
    loop = make_loop(path, contract, sharded, backend="delta", threshold=16.0)
    assert isinstance(loop.state if not sharded else loop.shard_states[0],
                      TS.DeltaRSNNState)
    eng = loop.engine
    for u, a in zip(FIRST_UTTS + LATER_UTTS, serve(loop)):
        np.testing.assert_array_equal(a, eng.run(u[None])[0][0].numpy())


@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
@pytest.mark.parametrize("contract", list(CONTRACTS))
def test_serving_launches_no_per_slot_reset(path, contract, sharded,
                                            monkeypatch):
    def boom(state, i):
        raise AssertionError("an eager per-slot reset while serving")

    monkeypatch.setattr(TS, "reset_slot_", boom)
    monkeypatch.setattr(SH, "reset_slot_", boom, raising=False)
    loop = make_loop(path, contract, sharded)
    got = serve(loop)
    assert [len(g) for g in got] == [*FIRST, *LATER]
    assert loop.resets == len(FIRST) + len(LATER)
