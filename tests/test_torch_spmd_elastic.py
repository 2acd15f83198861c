"""Elastic resume of the sharded token-LM train step (``tests/
torch_spmd.py``'s ``trainer`` scenario): yi-6b at ``reduce_config``
through the ``Trainer`` on a (2, 2) mesh of four gloo ranks, rank 1 alone
preempted after step 1 (every rank checkpoints step 2 and exits), then
resumed on a (2, 1) mesh of two ranks for step 2: the losses of all three
steps and the final parameters against a one-device ``Trainer`` of the
same seed and batches (within ``torch_spmd``'s tolerances); the
checkpoints written by rank 0 alone, whole leaves in ``shard_0.npz``
(``process_count`` 1, one writer), and the 4-rank one read by the
reference's ``Checkpointer`` as the port's ``restore`` reads it."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import json

import jax
import numpy as np
import pytest
import torch_spmd as h

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path

ARCH, TOTAL, PREEMPT_AFTER = "yi-6b", 3, 1


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_elastic")
    train = tmp / "train"
    h.run_ranks(tmp, 4, "trainer", tmp / "four", "2x2", PREEMPT_AFTER, TOTAL,
                ARCH, train)
    h.run_ranks(tmp, 2, "trainer", tmp / "two", "2x1", -1, TOTAL, ARCH,
                train)
    plain = h.plain_trainer(ARCH, tmp / "plain", TOTAL)
    return tmp, train, plain


def _reports(out, world):
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


def test_preemption_checkpoints_and_stops_every_rank(run):
    tmp, train, _ = run
    for rep in _reports(tmp / "four", 4):
        assert rep["steps"] == list(range(PREEMPT_AFTER + 1))
    for rep in _reports(tmp / "two", 2):
        assert rep["steps"] == list(range(PREEMPT_AFTER + 1, TOTAL))
    ckpt = Checkpointer(train / "ckpt")
    assert ckpt.steps() == [PREEMPT_AFTER + 1, TOTAL]
    for step in (PREEMPT_AFTER + 1, TOTAL):
        d = train / "ckpt" / f"step_{step}"
        assert sorted(p.name for p in d.iterdir()) == ["manifest.json",
                                                       "shard_0.npz"]
        assert json.loads((d / "manifest.json").read_text())[
            "process_count"] == 1


def test_resumed_run_matches_one_device_trainer(run):
    tmp, train, plain = run
    got, want = h.metrics_log(train), h.metrics_log(tmp / "plain")
    assert sorted(got) == sorted(want) == list(range(TOTAL))
    for s in range(TOTAL):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(got[s][k] - want[s][k]) <= h.LOSS_ATOL * max(
                1.0, abs(want[s][k])), (s, k)
    restored, step = Checkpointer(train / "ckpt").restore(plain["state"])
    assert step == TOTAL
    for (p, a), b in zip(tree_leaves_with_path(restored["params"]),
                         tree_leaves(plain["state"]["params"]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=h.PARAM_ATOL_PER_LR * h.LR,
                                   err_msg=p)
    assert int(restored["opt"]["step"]) == TOTAL


def test_four_rank_checkpoint_loads_in_the_reference(run):
    _, train, plain = run
    step = PREEMPT_AFTER + 1
    port, _ = Checkpointer(train / "ckpt").restore(plain["state"], step)
    template = jax.tree.map(lambda t: np.zeros(t.shape, t.numpy().dtype),
                            plain["state"])
    ref, got_step = JCheckpointer(train / "ckpt").restore(template, step)
    assert got_step == step
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    for p, t in tree_leaves_with_path(port):
        np.testing.assert_array_equal(t.numpy(), want[p])
