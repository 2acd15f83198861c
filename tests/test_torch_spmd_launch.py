"""``python -m repro_torch.launch.train`` under ``torchrun
--nproc-per-node 2`` on the CPU (two gloo ranks, the (2, 1) host mesh of
ranks, the sharded step): its logged losses and final checkpoint against a
one-device ``Trainer`` of the same seed, batches and settings run in this
process, within ``tests/torch_spmd.py``'s tolerances (the rate here is
``launch/train.py``'s 3e-3)."""

import torch_test_env  # noqa: F401  (first: one torch thread)

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch_spmd as h

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.launch import steps as steps_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.trainer import Trainer, TrainerConfig

ARCH, STEPS, BATCH, SEQ, LR = "yi-6b", 3, 8, 16, 3e-3  # main's lr
NPROC = 2


def test_torchrun_two_ranks_matches_one_device_trainer(tmp_path):
    out = tmp_path / "main"
    env = {**os.environ, "PYTHONPATH": str(h.ROOT / "src"),
           "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(NPROC), "-m", "repro_torch.launch.train",
         "--arch", ARCH, "--steps", str(STEPS), "--batch", str(BATCH),
         "--seq", str(SEQ), "--out", str(out), "--device", "cpu"],
        cwd=h.ROOT, env=env, capture_output=True, text=True,
        timeout=h.RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("final: ") == 1  # rank 0 alone prints

    cfg, api = h.model(ARCH)
    ocfg = opt_lib.OptimizerConfig(name="adamw", lr=LR,
                                   warmup_steps=max(STEPS // 20, 2),
                                   decay_steps=STEPS)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))

    def init_state():
        params = h.init_params(api)
        return {"params": params, "opt": opt_lib.init_opt_state(params,
                                                                 ocfg)}

    tcfg = TrainerConfig(total_steps=STEPS, log_every=10, ckpt_every=10,
                         out_dir=str(tmp_path / "direct"), resume=False)
    want = Trainer(tcfg, steps_lib.make_train_step(api, ocfg, donate=True),
                   init_state,
                   lambda s: {"tokens": stream.batch(BATCH, SEQ,
                                                     s)["tokens"]},
                   device="cpu").run()

    got_log, want_log = h.metrics_log(out), h.metrics_log(tmp_path /
                                                          "direct")
    assert sorted(got_log) == sorted(want_log) == [0, STEPS - 1]
    for s in got_log:
        assert abs(got_log[s]["loss"] - want_log[s]["loss"]) <= h.LOSS_ATOL
    manifest = json.loads((out / "ckpt" / f"step_{STEPS}" /
                           "manifest.json").read_text())
    assert manifest["process_count"] == 1  # rank 0 alone writes
    got, step = Checkpointer(out / "ckpt").restore(want["state"])
    assert step == STEPS
    for (p, a), b in zip(tree_leaves_with_path(got["params"]),
                         tree_leaves(want["state"]["params"]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=h.PARAM_ATOL_PER_LR * LR, err_msg=p)
    assert torch.equal(got["opt"]["step"], want["state"]["opt"]["step"])
