"""Dry run: trace every (arch x shape x mesh) cell and record what its step
costs a device, without running the step.

For each cell this builds the step function (the train step for train
shapes, the prefill or decode step for inference shapes) and its inputs
(parameters, optimizer state, cache, batch) on the ``meta`` device at full
width, runs the step once under ``analysis/op_cost.py`` ``OpCost`` (meta
tensors: nothing computed, nothing allocated), and writes one record a
mesh with the reference's file tag and keys.

The reference's ``launch/dryrun.py`` lowers and compiles each cell for
512 virtual devices and reads XLA's per-device SPMD program.  The port has
no SPMD partitioner, so a record mixes two kinds of figure:

  * from the specs, exact per device: the arguments', outputs' and
    aliased (donated) bytes of a device's block of each leaf
    (``distributed/sharding.py`` ``with_shardings``, the specs of
    ``tree_param_specs``, ``state_specs``, ``batch_specs`` and
    ``tree_cache_specs`` on ``launch/mesh.py``'s production meshes over
    meta devices);
  * from the trace, the global program's count divided by the devices
    (the ideal split): FLOPs, the eager program's memory traffic and its
    peak of live bytes (``temp_size_in_bytes``).  Redundant compute on
    replicated dims and the collectives are not seen:
    ``collective_bytes``, ``collective_counts`` and ``collective_total``
    are ``null``.

The global program does not depend on the mesh, so a cell is traced once
and both meshes' records come from that trace.  ``lower_s`` is the
trace's seconds; there is no compile.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.op_cost import OpCost
from repro_torch.configs.base import (LM_SHAPES, ShapeConfig,
                                      cell_is_runnable, shape_by_name)
from repro_torch.core.tree import PartitionSpec as P
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

PER_DEVICE = ("global trace / num_devices (ideal split; no SPMD partitioner: "
              "redundant compute and collectives not counted); eager bytes, "
              "no fusion")


def mesh_device(mesh) -> torch.device:
    """The device the cell's tensors are made on: ``meta`` for a mesh of
    meta devices; a real device only as a one-device mesh (the port runs
    one program, not one a device)."""
    dev = torch.device(mesh.devices.flat[0])
    if dev.type != "meta" and mesh.devices.size != 1:
        raise ValueError(f"a dry run on {dev} takes a one-device mesh, "
                         f"not {mesh.shape}")
    return dev


def _batch(cfg, shape: ShapeConfig, dev: torch.device, seed: int = 0
           ) -> dict:
    """``batch_shapes`` on ``dev``: on ``meta`` the shapes themselves,
    elsewhere seeded tokens in the vocab and N(0, 1) embeddings."""
    shapes = steps_lib.batch_shapes(cfg, shape)
    if dev.type == "meta":
        return shapes
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fill(t):
        if t.dtype == torch.int32:
            return torch.randint(cfg.vocab_size, t.shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randn(t.shape, generator=gen, device=dev,
                           dtype=torch.float32).to(t.dtype)

    return tree_map(fill, shapes)


def build(arch: str, shape: ShapeConfig, dev: torch.device,
          variant: str | None = None):
    """The cell's config, step function, its inputs made on ``dev`` and
    its donated arguments: (cfg, step_fn, args tuple, donate_argnums)."""
    from repro_torch.launch import variants as variants_lib

    cfg = variants_lib.apply(registry.get_model(arch).cfg, variant)
    api = registry.get_model(arch, cfg)
    gen = torch.Generator() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    params = api.init(gen, device=dev)
    batch = _batch(cfg, shape, dev)
    if shape.kind == "train":
        ocfg = OptimizerConfig(name=cfg.optimizer)
        state = {"params": params,
                 "opt": opt_lib.init_opt_state(params, ocfg)}
        step = steps_lib.make_train_step(api, ocfg, donate=True)
        return cfg, step, (state, batch), (0,)
    if shape.kind == "prefill":
        return cfg, steps_lib.make_prefill_step(api), (params, batch), ()
    # decode: params + cache + one-token batch
    cache = api.init_cache(shape.global_batch, shape.seq_len, device=dev)
    return cfg, steps_lib.make_decode_step(api), (params, cache, batch), (1,)


def arg_shardings(cfg, shape: ShapeConfig, args, mesh) -> tuple:
    """The ``Sharded`` tree of each argument of ``build``'s step on
    ``mesh``: the reference's ``input_specs`` shardings."""
    params = args[0]["params"] if shape.kind == "train" else args[0]
    pspecs = shd.tree_param_specs(params, mesh)
    params_sh = shd.with_shardings(params, pspecs, mesh)
    batch = args[-1]
    batch_sh = shd.with_shardings(batch, shd.batch_specs(batch, mesh), mesh)
    if shape.kind == "train":
        opt = args[0]["opt"]
        ospecs = opt_lib.state_specs(pspecs, params,
                                     OptimizerConfig(name=cfg.optimizer))
        return ({"params": params_sh,
                 "opt": shd.with_shardings(opt, ospecs, mesh)}, batch_sh)
    if shape.kind == "prefill":
        return params_sh, batch_sh
    cache = args[1]
    return params_sh, shd.with_shardings(
        cache, shd.tree_cache_specs(cache, mesh, shape.global_batch),
        mesh), batch_sh


def input_specs(arch: str, shape_name: str | ShapeConfig, mesh,
                variant: str | None = None):
    """The cell's step function and its inputs, made on the mesh's device
    (``mesh_device``).  Returns (step_fn, args tuple, donate_argnums, the
    args' ``Sharded`` trees).  ``shape_name`` may also be a
    ``ShapeConfig``, for a shape outside ``LM_SHAPES``.

    Where the reference returns output shardings, the port returns the
    arguments' (the eager step's outputs are whatever it returns;
    ``output_shardings`` places them)."""
    shape = shape_name if isinstance(shape_name, ShapeConfig) else \
        shape_by_name(shape_name)
    cfg, step, args, donate = build(arch, shape, mesh_device(mesh), variant)
    return step, args, donate, arg_shardings(cfg, shape, args, mesh)


def output_shardings(out, kind: str, mesh, batch: int, arg_sh):
    """The step's outputs placed as the reference's ``out_shardings``
    place them: a train step's state as its argument, its metrics
    replicated; the next tokens by ``batch_specs``, the cache by
    ``tree_cache_specs``."""
    if kind == "train":
        metrics = out[1]
        return arg_sh[0], shd.with_shardings(
            metrics, tree_map(lambda t: P(*([None] * t.dim())), metrics),
            mesh)
    tok, cache = out
    return (shd.with_shardings(tok, shd.batch_specs(tok, mesh), mesh),
            shd.with_shardings(cache, shd.tree_cache_specs(cache, mesh,
                                                            batch), mesh))


def _block_bytes(sharded_tree) -> int:
    return sum(s.block_bytes for s in tree_leaves(sharded_tree))


def trace(step, args) -> tuple[object, OpCost, float]:
    """``step(*args)`` once under ``OpCost``: (outputs, counter, seconds)."""
    t0 = time.perf_counter()
    with OpCost() as cost:
        out = step(*args)
    return out, cost, time.perf_counter() - t0


def aliased(out, args) -> list[bool]:
    """For each output leaf, whether it is an argument's storage (donated
    and updated in place, or passed through)."""
    keys = {t.untyped_storage()._cdata for t in tree_leaves(args)}
    return [t.untyped_storage()._cdata in keys for t in tree_leaves(out)]


def record(rec: dict, cost: OpCost, secs: float, arg_sh, out_sh,
           alias: list[bool], num_devices: int) -> dict:
    """Fill ``rec`` (arch, shape, mesh, variant) from one trace and one
    mesh's shardings, in the reference's keys."""
    c = cost.result()
    n = num_devices
    out_leaves = tree_leaves(out_sh)
    mem = {
        "argument_size_in_bytes": _block_bytes(arg_sh),
        "output_size_in_bytes": _block_bytes(out_sh),
        "alias_size_in_bytes": sum(s.block_bytes for s, a in
                                   zip(out_leaves, alias, strict=True) if a),
        "temp_size_in_bytes": c["peak_bytes"] / n,
    }
    tripaware = {
        "flops": c["flops"] / n,
        "hbm_bytes": c["hbm_bytes"] / n,
        "collective_bytes": None,
        "collective_counts": None,
        "collective_total": None,
        "num_computations": c["ops"],
        "flops_global": c["flops"],
        "hbm_bytes_global": c["hbm_bytes"],
        "per_device": PER_DEVICE,
    }
    rec.update(ok=True, lower_s=round(secs, 2), flops=tripaware["flops"],
               bytes_accessed=tripaware["hbm_bytes"], cost_keys=c,
               memory_analysis=mem, collectives=None, tripaware=tripaware,
               num_devices=n, hlo_size=None)
    return rec


def _tag(arch: str, shape_name: str, mesh_name: str,
         variant: str | None) -> str:
    return f"{arch}__{shape_name}__{mesh_name}" + (
        f"__{variant}" if variant else "")


def write_record(outdir: Path, tag: str, rec: dict) -> None:
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1,
                                                   default=str))


def meta_mesh(multi_pod: bool):
    return make_production_mesh(
        multi_pod=multi_pod, devices=["meta"] * (512 if multi_pod else 256))


def run_cells(arch: str, shape_name: str, meshes: list[bool], outdir: Path,
              variant: str | None = None) -> list[dict]:
    """One record for each mesh of ``meshes`` (``multi_pod`` flags), all
    from one trace of the cell; each written under its tag."""
    names = ["multipod" if mp else "pod" for mp in meshes]
    recs = [{"arch": arch, "shape": shape_name, "mesh": name, "ok": False,
             "variant": variant} for name in names]
    runnable, why = cell_is_runnable(arch, shape_by_name(shape_name))
    if not runnable:
        for rec in recs:
            rec.update(skipped=True, reason=why, ok=True)
        return recs
    try:
        shape = shape_by_name(shape_name)
        cfg, step, args, _ = build(arch, shape, torch.device("meta"),
                                   variant)
        shd.set_activation_axes(meta_mesh(meshes[0]))
        out, cost, secs = trace(step, args)
        alias = aliased(out, args)
        for mp, rec in zip(meshes, recs):
            mesh = meta_mesh(mp)
            arg_sh = arg_shardings(cfg, shape, args, mesh)
            out_sh = output_shardings(out, shape.kind, mesh,
                                      shape.global_batch, arg_sh)
            record(rec, cost, secs, arg_sh, out_sh, alias,
                   mesh.devices.size)
    except Exception as e:
        for rec in recs:
            if not rec["ok"]:
                rec.update(error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
    for name, rec in zip(names, recs):
        write_record(outdir, _tag(arch, shape_name, name, variant), rec)
    return recs


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: Path,
             variant: str | None = None) -> dict:
    return run_cells(arch, shape_name, [multi_pod], outdir, variant)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    outdir = Path(args.out)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(a, s.name) for a in registry.list_archs()
                 for s in LM_SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    for arch, shape in cells:
        todo = []
        for mp in meshes:
            tag = _tag(arch, shape, "multipod" if mp else "pod", None)
            if args.skip_existing and (outdir / f"{tag}.json").exists():
                prev = json.loads((outdir / f"{tag}.json").read_text())
                if prev.get("ok"):
                    print(f"[skip] {tag}")
                    continue
            todo.append(mp)
        if not todo:
            continue
        t0 = time.time()
        for mp, rec in zip(todo, run_cells(arch, shape, todo, outdir)):
            tag = _tag(arch, shape, rec["mesh"], None)
            status = ("SKIP " + rec.get("reason", "")[:40]) \
                if rec.get("skipped") else (
                    "ok" if rec["ok"] else "FAIL " + rec.get("error",
                                                             "")[:120])
            print(f"[{time.time()-t0:7.1f}s] {tag}: {status}", flush=True)


if __name__ == "__main__":
    main()
