"""Dry-run cells for the paper's own architecture (extra rows beyond the 40).

The RSNN is an always-on edge model; its datacenter-scale shape is
MANY CONCURRENT AUDIO STREAMS:
  rsnn_train:  4096 one-second utterances (100 frames) per step
  rsnn_serve:  65536 live streams, one 10-ms frame step each (the paper's
               real-time constraint: this step must finish in <10 ms)

Variants (§Perf):
  paper      — parallel time steps + merged-spike FC (the paper's dataflow)
  layerwise  — ablation: per-ts FC matmuls (no merged spike), the
               layer-by-layer dataflow the paper argues against
  ts1        — single-time-step execution

The reference's ``launch/rsnn_cells.py`` on ``launch/dryrun.py``'s terms:
the inputs on the ``meta`` device, one trace under ``OpCost`` for both
meshes, the same record.  The train step is ``core/rsnn.py`` ``loss_fn``,
``torch.autograd.grad`` and ``training/optimizer.py`` AdamW in place (the
reference's donated state); the serve step one ``frame_step`` and an
argmax.

  PYTHONPATH=src python -m repro_torch.launch.rsnn_cells [--both]
"""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import torch

from repro_torch.core import rsnn
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.tree import PartitionSpec as P
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig

RSNN_VARIANTS = {
    "paper": RSNNConfig(hidden_dim=128, num_ts=2, merged_spike=True),
    "layerwise": RSNNConfig(hidden_dim=128, num_ts=2, merged_spike=False),
    "ts1": RSNNConfig(hidden_dim=128, num_ts=1),
    "baseline256": RSNNConfig(hidden_dim=256, num_ts=2, merged_spike=True),
    # beyond-paper: the 0.1 MB model REPLICATES per chip (the analogue of
    # the paper's everything-on-chip SRAM) — no TP collectives at all,
    # the 'model' axis becomes extra stream parallelism
    "paper_dp": RSNNConfig(hidden_dim=128, num_ts=2, merged_spike=True),
}

TRAIN_BATCH, FRAMES = 4096, 100
SERVE_BATCH = 65536

RESULTS = Path("results/hillclimb_torch")


def make_train_step(cfg: RSNNConfig, ocfg: OptimizerConfig):
    """``train_step(state, batch) -> (state, metrics)``, the state updated
    in place."""
    def train_step(state, batch):
        params = state["params"]
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = rsnn.loss_fn(tree_unflatten(params, iter(leaves)), batch,
                                cfg)[0]
            grads = list(torch.autograd.grad(loss, leaves))
        _, _, m = opt_lib.apply_updates_(params, grads, state["opt"], ocfg)
        return state, dict(m, loss=loss.detach())

    return train_step


def make_serve_step(cfg: RSNNConfig):
    @torch.no_grad()
    def serve_step(params, state, x_t):
        st, (logits, _) = rsnn.frame_step(params, state, x_t, cfg)
        return torch.argmax(logits, -1).to(torch.int32), st

    return serve_step


def build(kind: str, variant: str, dev: torch.device):
    """(step_fn, args tuple, donate_argnums) with the inputs on ``dev``
    (``meta``: shapes only; elsewhere seeded weights, zero state and
    N(0, 1) features)."""
    cfg = RSNN_VARIANTS[variant]
    meta = dev.type == "meta"
    gen = torch.Generator() if meta else \
        torch.Generator(device=dev).manual_seed(0)
    params = rsnn.init_params(gen, cfg, device=dev)

    def data(shape, dtype=torch.float32, high=None):
        if meta:
            return torch.empty(shape, dtype=dtype, device=dev)
        if high is not None:
            return torch.randint(high, shape, generator=gen, device=dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    if kind == "rsnn_train":
        ocfg = OptimizerConfig(name="adamw")
        state = {"params": params,
                 "opt": opt_lib.init_opt_state(params, ocfg)}
        batch = {"features": data((TRAIN_BATCH, FRAMES, cfg.input_dim)),
                 "labels": data((TRAIN_BATCH, FRAMES), torch.int32,
                                cfg.fc_dim)}
        return make_train_step(cfg, ocfg), (state, batch), (0,)
    # rsnn_serve: one 10-ms frame step across SERVE_BATCH streams
    state = rsnn.init_state(cfg, SERVE_BATCH, cfg.num_ts, device=dev)
    x = data((SERVE_BATCH, cfg.input_dim))
    return make_serve_step(cfg), (params, state, x), (1,)


def arg_shardings(kind: str, variant: str, args, mesh) -> tuple:
    """The reference's shardings of ``build``'s arguments on ``mesh``: a
    ``_dp`` variant replicates the parameters and shards the streams over
    every axis."""
    multi_pod = "pod" in mesh.axis_names
    dp = variant.endswith("_dp")
    params = args[0]["params"] if kind == "rsnn_train" else args[0]
    if dp:
        pspecs = tree_map(lambda t: P(*([None] * t.dim())), params)
        # batch shards over EVERY axis: 256-way stream parallelism
        dax = ("pod", "data", "model") if multi_pod else ("data", "model")
    else:
        pspecs = shd.tree_param_specs(params, mesh)
        dax = ("pod", "data") if multi_pod else ("data",)
    bspec = dax if len(dax) > 1 else dax[0]
    params_sh = shd.with_shardings(params, pspecs, mesh)
    if kind == "rsnn_train":
        ocfg = OptimizerConfig(name="adamw")
        state, batch = args
        ospecs = opt_lib.state_specs(pspecs, params, ocfg)
        state_sh = {"params": params_sh,
                    "opt": shd.with_shardings(state["opt"], ospecs, mesh)}
        batch_sh = shd.with_shardings(
            batch, {"features": P(bspec, None, None),
                    "labels": P(bspec, None)}, mesh)
        return state_sh, batch_sh
    _, state, x = args
    if dp:
        sspecs = tree_map(lambda t: P(*[bspec if d == SERVE_BATCH else None
                                        for d in t.shape]), state)
    else:
        sspecs = shd.tree_cache_specs(state, mesh, SERVE_BATCH)
    return (params_sh, shd.with_shardings(state, sspecs, mesh),
            shd.with_shardings(x, P(bspec, None), mesh))


def input_specs(kind: str, variant: str, mesh):
    """``launch/dryrun.py`` ``input_specs`` for an RSNN cell: (step_fn,
    args, donate_argnums, the args' ``Sharded`` trees), the inputs made
    on the mesh's device."""
    step, args, donate = build(kind, variant, dryrun.mesh_device(mesh))
    return step, args, donate, arg_shardings(kind, variant, args, mesh)


def output_shardings(out, kind: str, mesh, arg_sh):
    """A train step's state as its argument, its metrics replicated; the
    serve step's tokens as the streams, its state as the argument's."""
    if kind == "rsnn_train":
        return dryrun.output_shardings(out, "train", mesh, TRAIN_BATCH,
                                       arg_sh)
    tok, _ = out
    return (shd.with_shardings(tok, P(arg_sh[2].spec[0]), mesh),
            arg_sh[1])


def run_rsnn_cells(kind: str, variant: str, meshes: list[bool],
                   outdir: Path) -> list[dict]:
    """One record for each mesh of ``meshes`` (``multi_pod`` flags), all
    from one trace of the cell; each written under its tag."""
    names = ["multipod" if mp else "pod" for mp in meshes]
    recs = [{"arch": "rsnn-timit", "shape": kind, "mesh": name,
             "variant": variant, "ok": False} for name in names]
    try:
        step, args, _ = build(kind, variant, torch.device("meta"))
        shd.set_activation_axes(dryrun.meta_mesh(meshes[0]))
        out, cost, secs = dryrun.trace(step, args)
        alias = dryrun.aliased(out, args)
        for mp, rec in zip(meshes, recs):
            mesh = dryrun.meta_mesh(mp)
            arg_sh = arg_shardings(kind, variant, args, mesh)
            dryrun.record(rec, cost, secs, arg_sh,
                          output_shardings(out, kind, mesh, arg_sh), alias,
                          mesh.devices.size)
    except Exception as e:
        for rec in recs:
            if not rec["ok"]:
                rec.update(error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-2500:])
    for name, rec in zip(names, recs):
        dryrun.write_record(outdir, f"rsnn-timit__{kind}__{name}__{variant}",
                            rec)
    return recs


def run_rsnn_cell(kind: str, variant: str, multi_pod: bool,
                  outdir: Path) -> dict:
    return run_rsnn_cells(kind, variant, [multi_pod], outdir)[0]


if __name__ == "__main__":
    import sys

    meshes = [False, True] if "--both" in sys.argv else [False]
    for kind in ("rsnn_train", "rsnn_serve"):
        for variant in RSNN_VARIANTS:
            t0 = time.time()
            for r in run_rsnn_cells(kind, variant, meshes, RESULTS):
                print(kind, variant, r["mesh"],
                      "ok" if r["ok"] else "FAIL " + r.get("error", "")[:120],
                      f"{time.time() - t0:.1f}s", flush=True)
