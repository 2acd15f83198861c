"""Training entry point for the token LMs.

  PYTHONPATH=src [torchrun --nproc-per-node N] python -m \
      repro_torch.launch.train --arch gemma2-2b --steps 100 [--reduced] \
      [--batch 8] [--seq 128] [--out runs/lm] [--device cuda|cpu]

Builds the host mesh, shards params per the rules in
repro_torch.distributed.sharding, and runs the fault-tolerant Trainer
(prefetch, async checkpoints, auto-resume, straggler monitor) on the
synthetic LM stream.  The reference's ``launch/train.py`` over a job of
ranks, one device a rank (``--device``, default ``cuda``, raising without
a GPU): under ``torchrun`` every rank joins its process group (NCCL for
``cuda``, gloo for ``cpu``) and the host mesh is the ranks' devices as
(N, 1); run alone, the process is a world of one (a ``HashStore`` group)
through the same path.  Every rank draws the same seeded parameters on
the CPU generator and keeps its block (``runtime/elastic.py``
``reshard_state`` on the mesh of ranks: DTensors), so the train step runs
SPMD (``launch/steps.py``); a world of one keeps every leaf whole, plain
tensors, and runs the plain step.  ``--reduced`` is on and cannot be turned off,
as in the reference (``store_true`` with ``default=True``).
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh, rank_device
from repro_torch.models import registry
from repro_torch.runtime.elastic import reshard_state
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def join_world(device: torch.device) -> bool:
    """Join the job's process group, if this process is in none: the one
    ``torchrun`` describes (``RANK`` and the rest in the environment), else
    a world of one over a ``HashStore``; NCCL for a CUDA device, gloo for
    the CPU.  Returns whether it made the group (the caller then destroys
    it)."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=registry.list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    own = join_world(device)
    try:
        return _train(args, device)
    finally:
        if own:
            dist.destroy_process_group()


def _train(args, device: torch.device) -> dict:
    cfg = registry.get_model(args.arch).cfg
    if args.reduced:
        cfg = registry.reduce_config(cfg)
    api = registry.get_model(args.arch, cfg)
    mesh = make_host_mesh(device=device)  # the ranks' devices, (N, 1)
    device = rank_device(device)
    shd.set_activation_axes(mesh)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))
    ocfg = OptimizerConfig(name=cfg.optimizer if not args.reduced else "adamw",
                           lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                           decay_steps=args.steps)

    def init_state():
        params = api.init(torch.Generator().manual_seed(0), device="cpu")
        (params,) = reshard_state(params, mesh)  # by tree_param_specs
        return {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}

    def make_batch(step: int) -> dict:
        return {"tokens": stream.batch(args.batch, args.seq, step)["tokens"]}

    tcfg = TrainerConfig(total_steps=args.steps, log_every=10,
                         ckpt_every=max(args.steps // 4, 10),
                         out_dir=args.out or f"runs/{args.arch}",
                         resume=not args.no_resume)
    out = Trainer(tcfg, steps_lib.make_train_step(api, ocfg, donate=True),
                  init_state, make_batch, device=device).run()
    if dist.get_rank() == 0:
        print(f"final: {out['metrics']}")
        if out["straggler_flags"]:
            print(f"straggler flags: {out['straggler_flags']}")
    return out


if __name__ == "__main__":
    main()
