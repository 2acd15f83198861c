"""repro_torch's async featurization front end (``data/featurize.py``) on
the CPU: the reference's nine cases of ``tests/test_featurize.py`` against
the port's ``AsyncFeaturizer`` (order, latched exhaustion and errors,
``close`` joining the worker, backpressure, the chunked loop's queue
sizing), ``prefetch_depth`` equal to the reference's over a grid, and its
doctests.  Timeouts guard every wait, so a hang fails instead of stalling
the suite.  Exact: the featurizer copies arrays and the quantizer is
elementwise."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import doctest
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import featurize as j_featurize
from repro_torch.core import rsnn
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.data import featurize
from repro_torch.data.featurize import AsyncFeaturizer, prefetch_depth
from repro_torch.serving import stream as TS
from repro_torch.serving.sharded import ShardedStreamLoop


def _ident(u):
    return u


def _drain(feat):
    return [np.asarray(x) for x in feat]


def _next_with_timeout(feat, timeout=5.0):
    """``next(feat)`` on a helper thread, so a hang fails the test."""
    box = {}

    def _call():
        try:
            box["value"] = next(feat)
        except BaseException as e:  # noqa: BLE001 - reraised below
            box["raised"] = e

    t = threading.Thread(target=_call, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "next() hung"
    if "raised" in box:
        raise box["raised"]
    return box["value"]


def test_yields_in_order_then_stops():
    utts = [np.full((3, 2), i, np.float32) for i in range(5)]
    out = _drain(AsyncFeaturizer(utts, _ident, depth=2))
    assert len(out) == 5
    for i, u in enumerate(out):
        np.testing.assert_array_equal(u, utts[i])


def test_exhaustion_is_latched():
    feat = AsyncFeaturizer([np.zeros((2, 2))], _ident, depth=2)
    assert len(_drain(feat)) == 1
    for _ in range(3):
        with pytest.raises(StopIteration):
            _next_with_timeout(feat)


def test_worker_error_propagates_and_latches():
    def bad(u):
        raise RuntimeError("featurize exploded")

    feat = AsyncFeaturizer([np.zeros((2, 2))], bad, depth=2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="featurize exploded"):
            _next_with_timeout(feat)


def test_error_mid_stream_after_good_items():
    calls = {"n": 0}

    def flaky(u):
        calls["n"] += 1
        if calls["n"] == 3:
            raise ValueError("bad utterance")
        return u

    feat = AsyncFeaturizer([np.zeros((2, 2))] * 5, flaky, depth=1)
    got = 0
    with pytest.raises(ValueError, match="bad utterance"):
        while True:
            _next_with_timeout(feat)
            got += 1
    assert got == 2


def test_close_joins_worker():
    feat = AsyncFeaturizer([np.zeros((2, 2))] * 50, _ident, depth=1)
    _next_with_timeout(feat)  # the worker is alive, blocked on put()
    feat.close()
    assert not feat._thread.is_alive()
    with pytest.raises(StopIteration):
        _next_with_timeout(feat)
    feat.close()  # idempotent


def test_close_after_exhaustion():
    feat = AsyncFeaturizer([np.zeros((2, 2))], _ident, depth=2)
    assert len(_drain(feat)) == 1
    feat.close()
    assert not feat._thread.is_alive()


def test_backpressure_bounds_queue():
    produced = []

    def record(u):
        produced.append(time.monotonic())
        return u

    feat = AsyncFeaturizer([np.zeros((2, 2))] * 20, record, depth=2)
    _next_with_timeout(feat)
    time.sleep(0.2)
    # queue(maxsize=2) + one blocked put + one returned item
    assert len(produced) <= 4
    feat.close()
    assert not feat._thread.is_alive()


def test_prefetch_depth_accounts_for_chunk():
    assert prefetch_depth(4, 2) == 6
    assert prefetch_depth(4, 2, chunk_frames=1) == 6
    assert prefetch_depth(2, 2, chunk_frames=4) == 24
    assert prefetch_depth(1, 0, chunk_frames=2) == 2
    assert prefetch_depth(4, 0, chunk_frames=8) == 32


def test_for_loop_sizes_queue_for_chunked_loop():
    """A burst of one-chunk utterances (every slot refills at every chunk
    boundary) through ``for_loop``'s front end, sized by the loop's chunk:
    logits bit-equal to raw submission."""
    cfg = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
    params = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    utts = [rng.normal(size=(t, 8)).astype(np.float32)
            for t in (2, 1, 3, 2, 1, 2, 3, 1, 2, 3, 1, 2)]

    def build():
        eng = TS.CompiledRSNN(cfg, params, TS.EngineConfig(input_scale=0.05),
                              device="cpu")
        return ShardedStreamLoop(eng, batch_slots=2, devices=["cpu"],
                                 max_frames=8, pipeline_depth=2,
                                 ring_frames=6, chunk_frames=3)

    ref = build()
    for u in utts:
        ref.submit(u)
    done_ref = ref.run()

    loop = build()
    feat = AsyncFeaturizer.for_loop(loop, utts)
    assert feat._q.maxsize == prefetch_depth(2, 2, chunk_frames=3)
    sids = loop.submit_stream(feat, quantized=True)
    done = loop.run()
    assert sids == [r.sid for r in done]
    assert len(done) == len(utts)
    for a, b in zip(done_ref, done):
        np.testing.assert_array_equal(a.stacked_logits(), b.stacked_logits())


@pytest.mark.parametrize("slots,depth,chunk", list(itertools.product(
    (1, 2, 4, 64, 256), (0, 1, 2, 3), (1, 2, 4))))
def test_prefetch_depth_equals_reference(slots, depth, chunk):
    assert prefetch_depth(slots, depth, chunk) == \
        j_featurize.prefetch_depth(slots, depth, chunk)


def test_doctests():
    result = doctest.testmod(featurize)
    assert result.attempted == 4 and result.failed == 0
