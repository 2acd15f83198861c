"""The slot loop's spans and counters (``serving/spans.py``) on the CPU.

A small int4 engine (the benchmark's ``fused`` path, FC as padded CSC)
serves seeded utterances through ``StreamLoop`` in each contract (v2
chunked as the benchmark runs it, v2 by frame, v1 by frame and chunked)
and through ``ShardedStreamLoop`` over two CPU shards.  Recording must
not change what the loop computes; the records must form the span tree
of ``serving/spans.py``, carry their request's id and lie on the clock
they were stamped on; the reset counter must count every reset, one at
each fill; a
profiler session must turn recording on and off; and a full ring must
be seen as one.
"""

import torch_test_env  # noqa: F401  (first: one torch thread)

import collections
import doctest
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import rsnn
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.serving import spans
from repro_torch.serving.sharded import ShardedStreamLoop
from repro_torch.serving.stream import (CompiledRSNN, EngineConfig,
                                        StreamLoop, _leaves)

ROOT = Path(__file__).resolve().parents[1]
CFG = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
# ragged tails at chunks of 4, a 1-frame and an empty stream, streams
# longer than the ring of 8 (watermark flushes)
LENS = (5, 9, 3, 12, 0, 7, 1, 10, 6, 17)
CONTRACTS = {"v2-chunk": dict(pipeline_depth=2, chunk_frames=4),
             "v2": dict(pipeline_depth=2),
             "v1": dict(pipeline_depth=0),
             "v1-chunk": dict(pipeline_depth=0, chunk_frames=4)}
SID_SPANS = (spans.RESET, spans.HARVEST, spans.MATERIALIZE)


@pytest.fixture(scope="module")
def engine():
    params = rsnn.init_params(torch.Generator().manual_seed(0), CFG)
    return CompiledRSNN(
        CFG, params, EngineConfig(backend="fused", precision="int4",
                                  sparse_fc=True, input_scale=0.05),
        CompressionConfig(fc_prune_frac=0.4, weight_bits=4), device="cpu")


@pytest.fixture(autouse=True)
def empty_ring():
    spans.clear()
    yield
    spans.clear()


def utterances():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(n, CFG.input_dim)).astype(np.float32)
            for n in LENS]


def make_loop(engine, contract="v2-chunk", sharded=False):
    kw = dict(CONTRACTS[contract], ring_frames=8)
    if sharded:
        return ShardedStreamLoop(engine, batch_slots=4, devices=["cpu"] * 2,
                                 max_frames=32, **kw)
    return StreamLoop(engine, batch_slots=4, **kw)


def serve(loop, record: bool):
    """Serve ``utterances()`` through ``loop`` to the end; returns the
    requests by sid (logits on the host)."""
    for u in utterances():
        loop.submit(u)
    if record:
        with spans.recording():
            done = loop.run()
    else:
        done = loop.run()
    return done


def counters(loop) -> tuple:
    return (loop.steps, loop.dispatches, loop.frames_served,
            loop.host_syncs, loop.resets, loop.finishes)


def enclosing(r, recs):
    """The innermost record of ``r``'s dispatch that holds ``r``."""
    holders = [p for p in recs if p is not r and p.dispatch == r.dispatch
               and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
    return min(holders, key=lambda p: p.end_ns - p.start_ns, default=None)


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_recording_changes_nothing_the_loop_computes(engine, contract):
    off = make_loop(engine, contract)
    done_off = serve(off, record=False)
    assert spans.records() == [] and spans.dropped() == 0
    on = make_loop(engine, contract)
    done_on = serve(on, record=True)
    assert spans.records()
    assert counters(on) == counters(off)
    assert [r.sid for r in done_on] == [r.sid for r in done_off]
    for a, b in zip(done_on, done_off):
        assert np.array_equal(a.stacked_logits(), b.stacked_logits())
    for a, b in zip(_leaves(on.state), _leaves(off.state)):
        assert torch.equal(a, b)
    assert on.sparsity_profile() == off.sparsity_profile()


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_records_form_the_span_tree(engine, contract):
    loop = make_loop(engine, contract)
    before = time.time_ns()
    done = serve(loop, record=True)
    after = time.time_ns()
    recs = spans.records()
    names = {r.name for r in recs}
    assert names <= set(spans.NAMES)
    want = {spans.STEP, spans.REFILL, spans.RESET, spans.PLAN, spans.STAGE,
            spans.DISPATCH}
    if loop.pipeline_depth:
        want |= {spans.ADVANCE, spans.HARVEST, spans.RETIRE,
                 spans.MATERIALIZE}
    assert want <= names
    for r in recs:
        assert before <= r.start_ns <= r.end_ns <= after
        if r.name == spans.STEP:
            assert enclosing(r, recs) is None and len(r.counts) == 4
            continue
        assert r.counts is None
        parent = enclosing(r, recs)
        assert parent is not None and parent.name in spans.PARENTS[r.name], r
    sids = {q.sid for q in done if len(q.frames)}
    for r in recs:
        if r.name in SID_SPANS:
            assert r.sid in sids, r
        else:
            assert r.sid == -1, r
    # every dispatch has one root, numbered as the loop counted
    roots = [r for r in recs if r.name == spans.STEP]
    dispatching = [r for r in roots if r.counts[0] > r.dispatch]
    assert [r.dispatch for r in dispatching] == list(range(loop.dispatches))
    assert roots[-1].counts[2:] == (loop.resets, loop.finishes)


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_every_reset_is_counted_and_spanned(engine, contract, monkeypatch):
    loop = make_loop(engine, contract)
    calls = []
    hook = loop._reset_slot
    monkeypatch.setattr(loop, "_reset_slot",
                        lambda i: (calls.append(i), hook(i)))
    for u in utterances():
        loop.submit(u)
    with spans.recording():
        for _ in range(3):
            loop.step_once()
        occupied = sum(r is not None for r in loop.slot_req)
        assert loop.resets == len(calls) == loop.finishes + occupied
        while loop.step_once():
            pass
    n_resets = sum(r.name == spans.RESET for r in spans.records())
    assert n_resets == loop.resets == len(calls)
    # a reset at each fill, none at a finish; the empty stream takes no
    # slot
    assert loop.finishes == sum(n > 0 for n in LENS)
    assert loop.resets == loop.finishes
    loop.reset_metrics()
    assert loop.resets == loop.finishes == 0


def test_sharded_loop_emits_the_same_spans(engine):
    serve(make_loop(engine), record=True)
    single = [(r.name, r.dispatch, r.sid) for r in spans.records()]
    spans.clear()
    loop = make_loop(engine, sharded=True)
    serve(loop, record=True)
    recs = spans.records()
    assert [(r.name, r.dispatch, r.sid) for r in recs] == single
    for r in recs:
        if r.name != spans.STEP:
            assert enclosing(r, recs).name in spans.PARENTS[r.name]
    assert loop.resets == sum(r.name == spans.RESET for r in recs)


def test_a_profiler_session_turns_recording_on_and_off(engine):
    loop = make_loop(engine)
    for u in utterances():
        loop.submit(u)
    loop.step_once()
    assert spans.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        loop.step_once()
        assert spans.on is False  # set for the length of a step only
    recs = spans.records()
    assert [r.name for r in recs].count(spans.STEP) == 1
    loop.step_once()
    assert spans.records() == recs


def test_a_full_ring_is_seen(engine, monkeypatch):
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=16))
    t0 = time.time_ns()
    serve(make_loop(engine), record=True)
    t1 = time.time_ns()
    assert spans.dropped() > 0 and len(spans.records()) == 16
    assert spans.window(t0, t1) is None
    # a window after the oldest kept record lost nothing
    late = spans.records()[0].end_ns + 1
    assert spans.window(late, t1) == [r for r in spans.records()
                                      if r.start_ns >= late]
    spans.clear()
    assert spans.dropped() == 0 and spans.window(t0, t1) == []


def test_tracing_section_of_the_serving_docs_runs():
    text = (ROOT / "docs" / "tracing.md").read_text()
    test = doctest.DocTestParser().get_doctest(text, {}, "tracing.md",
                                               "docs/tracing.md", 0)
    assert test.examples
    runner = doctest.DocTestRunner(optionflags=doctest.ELLIPSIS)
    runner.run(test)
    assert runner.failures == 0
