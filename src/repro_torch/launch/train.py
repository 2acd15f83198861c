"""Training entry point for the token LMs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
      --steps 100 [--reduced] [--batch 8] [--seq 128] [--out runs/lm] \
      [--device cuda|cpu]

Builds the host mesh, shards params per the rules in
repro_torch.distributed.sharding, and runs the fault-tolerant Trainer
(prefetch, async checkpoints, auto-resume, straggler monitor) on the
synthetic LM stream.  The reference's ``launch/train.py`` on one device
(``--device``, default ``cuda``, raising without a GPU): the ``Trainer``
runs one process on one device, so the mesh is that device alone, (1, 1),
and placing the parameters by their specs (``runtime/elastic.py``
``reshard_state``, one part) hands back the same tensors.  ``--reduced``
is on and cannot be turned off, as in the reference (``store_true`` with
``default=True``).
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import LMDataConfig, MarkovLMStream
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.runtime.elastic import reshard_state
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


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

    cfg = registry.get_model(args.arch).cfg
    if args.reduced:
        cfg = registry.reduce_config(cfg)
    api = registry.get_model(args.arch, cfg)
    mesh = make_host_mesh([device])
    shd.set_activation_axes(mesh)
    stream = MarkovLMStream(LMDataConfig(vocab_size=cfg.vocab_size))
    ocfg = OptimizerConfig(name=cfg.optimizer if not args.reduced else "adamw",
                           lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                           decay_steps=args.steps)

    def init_state():
        params = api.init(torch.Generator(device=device).manual_seed(0),
                          device=device)
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
    print(f"final: {out['metrics']}")
    if out["straggler_flags"]:
        print(f"straggler flags: {out['straggler_flags']}")
    return out


if __name__ == "__main__":
    main()
