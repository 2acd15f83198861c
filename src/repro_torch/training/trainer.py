"""Generic fault-tolerant training loop.

Features (all exercised by tests/examples):
  * the train step with a donated state,
  * background-prefetched, seekable data (exact-replay resume),
  * async checkpointing every `ckpt_every` steps + checkpoint-on-preempt,
  * auto-resume from the latest checkpoint (step-accurate),
  * straggler monitor + heartbeat,
  * metrics JSONL log.

The reference's ``training/trainer.py`` on one device, eager: the step is
called as it is given (no ``jit``, no CUDA graph).  Donation is the
step factory's alone (``launch/steps.py`` ``make_train_step(...,
donate=True)`` updates the state in place), so the trainer takes no
``donate`` of its own.  Resume makes one fresh state and copies the
checkpoint into it leaf by leaf (``Checkpointer.restore_into``), where
the reference restores into a ``jax.eval_shape`` template: either way one
state is on the device.

Under a process group (a state on a mesh of ranks, ``launch/train.py``)
the ``Trainer`` runs on every rank with the same global batches: every
rank takes part in each checkpoint's gather, and rank 0 alone writes it,
``metrics.jsonl`` and the heartbeat.  Ranks of a world of several agree
every step on whether any of them was preempted (one all-reduce of a
flag), so that a preemption checkpoints and exits on every rank.  Resume
restores each rank's blocks into a state placed on the current mesh,
whatever mesh wrote the checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer, process
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.runtime.fault_tolerance import (Heartbeat, PreemptionHandler,
                                                 StragglerMonitor)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    log_every: int = 20
    ckpt_every: int = 200
    keep_ckpts: int = 3
    out_dir: str = "runs/default"
    resume: bool = True


def _host(x) -> float:
    return float(x.item() if isinstance(x, torch.Tensor) else x)


class Trainer:
    def __init__(self, tcfg: TrainerConfig, train_step: Callable,
                 init_state: Callable[[], dict],
                 make_batch: Callable[[int], dict],
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.tcfg = tcfg
        self.rank, self.world = process()
        self.out = Path(tcfg.out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.ckpt = Checkpointer(self.out / "ckpt", keep=tcfg.keep_ckpts)
        self.step_fn = train_step
        self.preempt = PreemptionHandler()
        self.straggler = StragglerMonitor()
        self.heartbeat = Heartbeat(self.out / "heartbeat", interval_s=5.0) \
            if self.rank == 0 else None
        self.metrics_path = self.out / "metrics.jsonl"
        self._make_batch = make_batch
        self._init_state = init_state

    def run(self, hooks: list[Callable] | None = None) -> dict:
        tcfg = self.tcfg
        start_step = 0
        state = self._init_state()
        if tcfg.resume and self.ckpt.latest_step() is not None:
            start_step = self.ckpt.restore_into(state)
            self._print(f"[trainer] resumed from step {start_step}")

        data = PrefetchIterator(self._make_batch, start_step=start_step,
                                device=self.device)
        log = self.metrics_path.open("a") if self.rank == 0 else None
        last = {}
        try:
            for step in range(start_step, tcfg.total_steps):
                data_step, batch = next(data)
                assert data_step == step, (data_step, step)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                metrics = {k: _host(v) for k, v in metrics.items()}
                dt = time.time() - t0
                slow = self.straggler.record(step, dt)
                if self.rank == 0 and (step % tcfg.log_every == 0
                                       or step == tcfg.total_steps - 1):
                    rec = dict(metrics, step=step, sec_per_step=round(dt, 4))
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                    print(f"[trainer] step {step} " +
                          " ".join(f"{k}={v:.4g}" for k, v in metrics.items()) +
                          (" STRAGGLER" if slow else ""))
                for h in hooks or []:
                    h(step, state, metrics)
                if self._preempted():
                    self._print(f"[trainer] preempted at step {step}: "
                                "checkpointing")
                    self.ckpt.save(step + 1, state, blocking=True)
                    last = metrics
                    break
                if (step + 1) % tcfg.ckpt_every == 0:
                    self.ckpt.save(step + 1, state)
                last = metrics
            else:
                self.ckpt.save(tcfg.total_steps, state, blocking=True)
        finally:
            data.close()
            if log is not None:
                log.close()
            if self.heartbeat is not None:
                self.heartbeat.stop()
            self.ckpt.wait()
        return {"state": state, "metrics": last,
                "straggler_flags": self.straggler.flags}

    def _print(self, msg: str) -> None:
        if self.rank == 0:
            print(msg)

    def _preempted(self) -> bool:
        """Whether any rank was preempted (this one alone in a world of
        one)."""
        flag = self.preempt.preempted()
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())
