"""The paper's full training recipe (§II-D3, §IV-A) as a declarative,
resumable **compression pipeline**:

  1. BASELINE    — hidden 256, inherent temporal training (high TS -> low TS)
  2. +STRUCTURED — hidden 128, trained from scratch (predefined pruning)
  3. +UNSTRUCT   — 40% magnitude pruning of the FC, fine-tuned with masks
  4. +QAT        — 4-bit fixed-point weight quantization, fine-tuned

Stages are *data* (``PipelineStage``: model config, compression config,
temporal schedule, which earlier stage seeds the weights) executed by
``CompressionPipeline``, a driver that

  * checkpoints every completed stage through ``checkpoint/Checkpointer``
    under ``workdir/stages/<name>/`` and records it in a pipeline manifest
    (``pipeline.json``), so ``run(resume=True)`` restores finished stages
    from disk instead of retraining them — a recipe interrupted after
    stage *k* resumes at stage *k+1*;
  * emits structured per-step and per-stage metric records (dicts through
    a pluggable ``metric_sink``, mirrored to ``metrics.jsonl`` when a
    workdir is set) instead of printing;
  * hands the final QAT stage to ``export_artifact``, which packs the
    model (``core/sparse.py``) and writes the deployment artifact
    (``core/artifact.py``) that ``CompiledRSNN.from_artifact`` serves.

Each stage reports frame error rate, measured sparsity (which drives the
zero-skipping cycle and complexity models), model size and MMAC/s.

Training is plain PyTorch on one device (``device``, ``"cuda"`` unless
the caller asks for the CPU; no GPU raises), the reference's recipe step
for step: ``rsnn.loss_fn`` back-propagates through every frame with the
surrogate spike gradient, and ``optimizer.apply_updates`` (AdamW) updates
the parameters.  It reaches no hand-written kernel, as the reference's
training reaches no Pallas kernel; the exported model is served through
them.  Manifests fingerprint the port's stage recipes, so a pipeline
resumes within this package; stage checkpoints are the reference's files.

Run the paper recipe from the command line:

  PYTHONPATH=src python -m repro_torch.training.rsnn_pipeline \\
      --workdir runs/pipe --steps 90 [--resume] [--stop-after structured] \\
      [--artifact runs/pipe/artifact] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import complexity, rsnn, sparse, spike_ops
from repro_torch.core import artifact as artifact_lib
from repro_torch.core.compression import (CompressionConfig,
                                          CompressionState,
                                          compressed_size_bytes,
                                          init_compression, materializer,
                                          pack_for_inference,
                                          structured_prune_config)
from repro_torch.core.lif import LIFParams
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.temporal import TemporalSchedule
from repro_torch.data.synthetic import SpeechDataConfig, TimitLikeStream
from repro_torch.serving.stream import resolve_device
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.optimizer import OptimizerConfig

log = logging.getLogger("repro_torch.pipeline")

PIPELINE_SCHEMA_VERSION = 1
PIPELINE_MANIFEST = "pipeline.json"


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """One declarative stage of the compression recipe.

    ``init_from`` names an *earlier* stage whose trained parameters seed
    this one (the paper fine-tunes unstructured pruning and QAT from the
    structured model); ``None`` trains from scratch.  ``steps=None``
    inherits the pipeline-wide step count.
    """

    name: str
    cfg: RSNNConfig
    ccfg: CompressionConfig = CompressionConfig()
    schedule: TemporalSchedule | None = None
    init_from: str | None = None
    steps: int | None = None
    lr: float = 3.5e-3
    seed: int = 0


@dataclasses.dataclass
class StageResult:
    name: str
    cfg: RSNNConfig
    ccfg: CompressionConfig
    params: Any
    cstate: Any
    error_rate: float
    loss: float
    sparsity: complexity.SparsityProfile
    size_bytes: float
    mmac_dense: float
    mmac_skip: float

    def metrics(self) -> dict:
        """The JSON-serializable summary stored in the pipeline manifest."""
        return {
            "error_rate": self.error_rate, "loss": self.loss,
            "size_bytes": self.size_bytes, "mmac_dense": self.mmac_dense,
            "mmac_skip": self.mmac_skip,
            "sparsity": dataclasses.asdict(self.sparsity),
        }


def _batch_on(b: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def make_train_step(cfg: RSNNConfig, ocfg: OptimizerConfig,
                    ccfg: CompressionConfig, cstate, num_ts: int):
    """``train_step(state, batch) -> (state, metrics)``: the loss and its
    gradient in every parameter, then one optimizer update.  ``state`` is
    ``{"params", "opt"}``; the new state holds new tensors."""
    mat = materializer(ccfg, cstate)

    def train_step(state, batch):
        params = opt_lib.tree_map(
            lambda p: p.detach().requires_grad_(True), state["params"])
        leaves = opt_lib.tree_leaves(params)
        loss, aux = rsnn.loss_fn(params, batch, cfg, materialize=mat,
                                 num_ts=num_ts)
        grads = opt_lib.tree_unflatten(params, iter(torch.autograd.grad(
            loss, leaves)))
        new_params, new_opt, metrics = opt_lib.apply_updates(
            state["params"], grads, state["opt"], ocfg)
        metrics = dict(metrics, loss=loss.detach(),
                       frame_error_rate=aux["frame_error_rate"].detach())
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


@torch.no_grad()
def evaluate(params, cfg: RSNNConfig, ccfg: CompressionConfig, cstate,
             stream: TimitLikeStream, batches: int = 8, batch_size: int = 32,
             num_ts: int | None = None) -> dict:
    """Loss, frame error rate and measured sparsity over ``batches``
    held-out batches, on the parameters' device."""
    mat = materializer(ccfg, cstate)
    device = params["fc_w"].device
    losses, errs = [], []
    rates = {"l0": [], "l1": [], "union_l1": [], "in_bits": []}
    for i in range(batches):
        batch = _batch_on(stream.batch(batch_size, step=10_000 + i), device)
        loss, aux = rsnn.loss_fn(params, batch, cfg, materialize=mat,
                                 num_ts=num_ts)
        losses.append(float(loss))
        errs.append(float(aux["frame_error_rate"]))
        rates["l0"].append([float(x) for x in aux["spike_rate_l0"]])
        rates["l1"].append([float(x) for x in aux["spike_rate_l1"]])
        rates["union_l1"].append(float(aux["union_rate_l1"]))
        rates["in_bits"].append(1.0 - float(aux["input_bit_sparsity"]))
    # per-ts densities at whatever num_ts actually ran (1, 2, 4, ...)
    l0 = np.mean(rates["l0"], axis=0)
    l1 = np.mean(rates["l1"], axis=0)
    sp = complexity.SparsityProfile(
        input_bit_density=float(np.mean(rates["in_bits"])),
        l0_density=tuple(float(x) for x in l0),
        l1_density=tuple(float(x) for x in l1),
        fc_density=tuple(float(x) for x in l1),
        fc_union_density=float(np.mean(rates["union_l1"])),
    )
    return {"loss": float(np.mean(losses)), "error_rate": float(np.mean(errs)),
            "sparsity": sp}


def _default_sink(record: dict) -> None:
    log.info("%s", record)


def train_stage(name: str, cfg: RSNNConfig, ccfg: CompressionConfig,
                stream: TimitLikeStream, steps: int, batch_size: int,
                schedule: TemporalSchedule | None = None,
                init_params: Any | None = None, lr: float = 3.5e-3,
                eval_batches: int = 8, seed: int = 0,
                log_every: int = 50,
                metric_sink: Callable[[dict], None] | None = None,
                device: torch.device | str = "cuda") -> StageResult:
    """One pipeline stage on ``device``; ``schedule`` enables inherent
    temporal training.  ``init_params`` (an upstream stage's) are cloned
    onto ``device`` and stay as they were; else the weights are drawn
    from ``torch.Generator(device).manual_seed(seed)``.

    Per-step training metrics go to ``metric_sink`` as structured records
    (default: the module logger), never to stdout.
    """
    device = resolve_device(device)
    sink = metric_sink or _default_sink
    if init_params is not None:
        params = opt_lib.tree_map(lambda x: x.detach().to(device).clone(),
                                  init_params)
    else:
        params = rsnn.init_params(
            torch.Generator(device).manual_seed(seed), cfg)
    cstate = init_compression(params, ccfg)
    ocfg = OptimizerConfig(name="adamw", lr=lr,
                           warmup_steps=max(steps // 20, 5),
                           decay_steps=steps, weight_decay=0.0)
    # the optimizer state carries across the schedule's TS boundaries;
    # only the step function is rebuilt per TS
    state = {"params": params, "opt": opt_lib.init_opt_state(params, ocfg)}

    steps_done = 0
    stages = schedule.stages if schedule else ((cfg.num_ts, steps),)
    for num_ts, stage_steps in stages:
        step_fn = make_train_step(cfg, ocfg, ccfg, cstate, num_ts)
        for i in range(stage_steps):
            batch = _batch_on(stream.batch(batch_size, step=steps_done + i),
                              device)
            state, metrics = step_fn(state, batch)
            if (steps_done + i) % log_every == 0:
                sink({"stage": name, "event": "train", "num_ts": num_ts,
                      "step": steps_done + i,
                      "loss": float(metrics["loss"]),
                      "frame_error_rate": float(metrics["frame_error_rate"])})
        steps_done += stage_steps

    ev = evaluate(state["params"], cfg, ccfg, cstate, stream,
                  batches=eval_batches, batch_size=batch_size)
    size = compressed_size_bytes(state["params"], ccfg, cstate)
    result = StageResult(
        name=name, cfg=cfg, ccfg=ccfg, params=state["params"], cstate=cstate,
        error_rate=ev["error_rate"], loss=ev["loss"], sparsity=ev["sparsity"],
        size_bytes=size,
        mmac_dense=complexity.mmac_per_second(
            cfg, cfg.num_ts, fc_prune_frac=ccfg.fc_prune_fraction),
        mmac_skip=complexity.mmac_per_second(
            cfg, cfg.num_ts, sparsity=ev["sparsity"], merged_spike=True,
            fc_prune_frac=ccfg.fc_prune_fraction))
    sink({"stage": name, "event": "eval", "step": steps_done,
          **result.metrics()})
    return result


class CompressionPipeline:
    """Driver for a declarative compression recipe.

    ``stages`` is an ordered tuple of ``PipelineStage``; the driver trains
    them in sequence on ``device``, threading ``init_from`` parameters,
    and (with a ``workdir``) checkpoints every completed stage so
    ``run(resume=True)`` restores stages already on disk instead of
    retraining them.  The manifest also fingerprints each stage's recipe:
    resuming with a *changed* recipe for a finished stage fails loudly
    rather than serving stale weights.
    """

    def __init__(self, stages, stream: TimitLikeStream, *,
                 workdir: str | Path | None = None, steps: int = 300,
                 batch_size: int = 32, eval_batches: int = 8,
                 log_every: int = 50,
                 metric_sink: Callable[[dict], None] | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.stages = tuple(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        seen: set[str] = set()
        for s in self.stages:
            if s.init_from is not None and s.init_from not in seen:
                raise ValueError(
                    f"stage {s.name!r} init_from={s.init_from!r} must name "
                    f"an earlier stage (have {sorted(seen)})")
            seen.add(s.name)
        self.stream = stream
        self.workdir = Path(workdir) if workdir is not None else None
        self.steps = steps
        self.batch_size = batch_size
        self.eval_batches = eval_batches
        self.log_every = log_every
        self.metric_sink = metric_sink
        self.history: dict[str, list[dict]] = {s.name: [] for s in self.stages}
        # recipe fingerprints, chained through init_from and including the
        # data config: a change to any upstream stage's recipe (or to the
        # training data) invalidates every stage fine-tuned from it, so
        # resume can never serve weights the current recipe didn't produce
        self._fps: dict[str, str] = {}
        data_cfg = getattr(self.stream, "cfg", None)
        for s in self.stages:
            self._fps[s.name] = repr(
                (s, self._effective_steps(s), self.batch_size, data_cfg,
                 self._fps.get(s.init_from)))

    # ------------------------------------------------------------- layout

    def _stage_dir(self, name: str) -> Path:
        return self.workdir / "stages" / name

    def _manifest_path(self) -> Path:
        return self.workdir / PIPELINE_MANIFEST

    def _load_manifest(self) -> dict:
        p = self._manifest_path()
        if not p.exists():
            return {"schema_version": PIPELINE_SCHEMA_VERSION, "stages": {}}
        manifest = json.loads(p.read_text())
        if manifest.get("schema_version") != PIPELINE_SCHEMA_VERSION:
            raise ValueError(
                f"pipeline manifest schema "
                f"{manifest.get('schema_version')!r} not supported "
                f"(wants {PIPELINE_SCHEMA_VERSION})")
        return manifest

    def _write_manifest(self, manifest: dict) -> None:
        p = self._manifest_path()
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(".tmp")
        tmp.write_text(json.dumps(manifest, indent=1))
        tmp.rename(p)  # atomic: a killed run never corrupts the manifest

    def _effective_steps(self, stage: PipelineStage) -> int:
        return self.steps if stage.steps is None else stage.steps

    def _emit(self, stage_name: str, record: dict) -> None:
        self.history[stage_name].append(record)
        if self.workdir is not None:
            d = self._stage_dir(stage_name)
            d.mkdir(parents=True, exist_ok=True)
            with (d / "metrics.jsonl").open("a") as f:
                f.write(json.dumps(record) + "\n")
        (self.metric_sink or _default_sink)(record)

    # ------------------------------------------------------- save/restore

    def _save_stage(self, stage: PipelineStage, result: StageResult,
                    manifest: dict) -> None:
        if self.workdir is None:
            return
        step = self._effective_steps(stage)
        ck = Checkpointer(self._stage_dir(stage.name) / "ckpt", keep=1)
        # the masks are part of the trained state: they were cut from the
        # *seed* params, and masked weights stay frozen at init while kept
        # weights train — recomputing masks from the final params would
        # flip entries and change the deployed sparsity pattern on resume
        ck.save(step, {"params": result.params,
                       "masks": dict(result.cstate.masks)}, blocking=True)
        manifest["stages"][stage.name] = {
            "status": "done", "ckpt_step": step,
            "fingerprint": self._fps[stage.name],
            "metrics": result.metrics(),
        }
        self._write_manifest(manifest)

    def _stage_restorable(self, stage: PipelineStage, manifest: dict) -> bool:
        entry = manifest["stages"].get(stage.name)
        if entry is None or entry.get("status") != "done":
            return False
        if not (self._stage_dir(stage.name) / "ckpt").exists():
            return False
        if entry["fingerprint"] != self._fps[stage.name]:
            raise ValueError(
                f"stage {stage.name!r} was checkpointed with a different "
                f"recipe; refuse to resume over it (delete "
                f"{self._stage_dir(stage.name)} to retrain)")
        return True

    def _restore_stage(self, stage: PipelineStage,
                       manifest: dict) -> StageResult:
        entry = manifest["stages"][stage.name]

        def empty(shape):
            return torch.empty(shape, dtype=torch.float32, device=self.device)

        h = (stage.cfg.hidden_dim,)
        template = {n: empty(s) for n, s in stage.cfg.layer_shapes.items()}
        for i in (0, 1):
            template[f"lif{i}"] = LIFParams(raw_beta=empty(h),
                                            raw_vth=empty(h))
        mask_template = {n: empty(template[n].shape)
                         for n in stage.ccfg.resolved_prune_specs}
        ck = Checkpointer(self._stage_dir(stage.name) / "ckpt")
        restored, _ = ck.restore({"params": template, "masks": mask_template},
                                 step=entry["ckpt_step"])
        m = dict(entry["metrics"])
        spd = dict(m["sparsity"])
        for k in ("l0_density", "l1_density", "fc_density"):
            spd[k] = tuple(spd[k])
        return StageResult(
            name=stage.name, cfg=stage.cfg, ccfg=stage.ccfg,
            params=restored["params"],
            cstate=CompressionState(masks=restored["masks"]),
            error_rate=m["error_rate"], loss=m["loss"],
            sparsity=complexity.SparsityProfile(**spd),
            size_bytes=m["size_bytes"], mmac_dense=m["mmac_dense"],
            mmac_skip=m["mmac_skip"])

    # ---------------------------------------------------------------- run

    def run(self, resume: bool = False,
            stop_after: str | None = None) -> list[StageResult]:
        """Execute (or resume) the recipe; returns the completed
        ``StageResult``s in stage order.

        ``resume=True`` (requires a workdir) restores every stage the
        manifest marks done — bit-for-bit the checkpointed parameters —
        and trains only the remainder.  ``stop_after`` ends the run after
        the named stage completes (a mid-recipe kill, simulated).
        """
        names = [s.name for s in self.stages]
        if stop_after is not None and stop_after not in names:
            raise ValueError(f"stop_after={stop_after!r} is not a stage "
                             f"({names})")
        if resume and self.workdir is None:
            raise ValueError("resume=True needs a workdir to restore from")
        manifest = (self._load_manifest() if self.workdir is not None
                    else {"schema_version": PIPELINE_SCHEMA_VERSION,
                          "stages": {}})
        if not resume:
            manifest["stages"] = {}

        results: dict[str, StageResult] = {}
        for stage in self.stages:
            if resume and self._stage_restorable(stage, manifest):
                results[stage.name] = self._restore_stage(stage, manifest)
                self._emit(stage.name, {
                    "stage": stage.name, "event": "restored",
                    "ckpt_step": manifest["stages"][stage.name]["ckpt_step"],
                    **results[stage.name].metrics()})
                if stop_after == stage.name:
                    break
                continue
            if self.workdir is not None:
                # this stage is about to (re)train: drop records of any
                # previous run/attempt so metrics.jsonl covers one run only
                mpath = self._stage_dir(stage.name) / "metrics.jsonl"
                mpath.unlink(missing_ok=True)
            init = (results[stage.init_from].params
                    if stage.init_from is not None else None)
            result = train_stage(
                stage.name, stage.cfg, stage.ccfg, self.stream,
                self._effective_steps(stage), self.batch_size,
                schedule=stage.schedule, init_params=init, lr=stage.lr,
                eval_batches=self.eval_batches, seed=stage.seed,
                log_every=self.log_every,
                metric_sink=functools.partial(self._emit, stage.name),
                device=self.device)
            results[stage.name] = result
            self._save_stage(stage, result, manifest)
            if stop_after == stage.name:
                break
        return [results[n] for n in names if n in results]


# --------------------------------------------------------------- the recipe


def paper_stages(steps: int = 300, hidden_base: int = 256,
                 hidden_pruned: int = 128, fc_dim: int = 1920,
                 temporal: bool = True, seed: int = 0
                 ) -> tuple[PipelineStage, ...]:
    """The paper's four-stage recipe as declarative stage data."""
    base_cfg = RSNNConfig(hidden_dim=hidden_base, fc_dim=fc_dim, num_ts=2)
    pruned_cfg = structured_prune_config(base_cfg, hidden_pruned)
    sched = TemporalSchedule(stages=((4, steps // 3), (2, steps - steps // 3))) \
        if temporal else None
    unstruct = CompressionConfig(fc_prune_frac=0.4)
    qat = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    return (
        PipelineStage("baseline", base_cfg, schedule=sched, seed=seed),
        PipelineStage("structured", pruned_cfg, schedule=sched, seed=seed + 1),
        PipelineStage("unstructured", pruned_cfg, unstruct,
                      init_from="structured", seed=seed),
        PipelineStage("qat4", pruned_cfg, qat, init_from="unstructured",
                      seed=seed),
    )


def export_artifact(result: StageResult, path: str | Path, *,
                    input_scale=None, backend: str = "jnp") -> Path:
    """Pack a finished QAT stage (on its parameters' device) and write the
    deployment artifact.

    The packer's measured size report must agree with the training-side
    ``compressed_size_bytes`` (one Fig. 12 number, two independent
    computations) — a mismatch means the compression config quantizes
    only part of the model and is refused.
    """
    if result.ccfg.quant_spec is None:
        raise ValueError(
            f"stage {result.name!r} is not quantized (weight_bits unset); "
            f"export the QAT stage")
    packed = pack_for_inference(result.params, result.cfg, result.ccfg,
                                result.cstate)
    report = sparse.packed_size_report(packed)
    trained_side = compressed_size_bytes(result.params, result.ccfg,
                                         result.cstate)
    if abs(report["broadcast_total_bytes"] - trained_side) > 0.5:
        raise ValueError(
            f"size accounting mismatch: packed artifact stores "
            f"{report['broadcast_total_bytes']:.0f} B but the training-side "
            f"accounting says {trained_side:.0f} B — is every 2-D weight in "
            f"quant_names?")
    return artifact_lib.save_artifact(
        path, cfg=result.cfg, packed=packed, ccfg=result.ccfg,
        sparsity=result.sparsity, input_scale=input_scale, backend=backend)


def run_pipeline(steps: int = 300, batch_size: int = 32,
                 hidden_base: int = 256, hidden_pruned: int = 128,
                 data_cfg: SpeechDataConfig | None = None,
                 temporal: bool = True, seed: int = 0,
                 workdir: str | Path | None = None, resume: bool = False,
                 stop_after: str | None = None,
                 artifact_path: str | Path | None = None,
                 device: torch.device | str = "cuda",
                 metric_sink: Callable[[dict], None] | None = None,
                 log_every: int = 50) -> list[StageResult]:
    """The paper's four-stage recipe on ``device``.  ``steps`` is per
    stage (paper: 72 epochs).

    With ``workdir``, every finished stage is checkpointed and
    ``resume=True`` continues an interrupted run; ``artifact_path`` packs
    the final QAT stage into the on-disk deployment artifact (calibrating
    the static input scale on the training stream).  ``metric_sink`` and
    ``log_every`` go to the pipeline's records.
    """
    data_cfg = data_cfg or SpeechDataConfig()
    stream = TimitLikeStream(data_cfg)
    stages = paper_stages(steps=steps, hidden_base=hidden_base,
                          hidden_pruned=hidden_pruned,
                          fc_dim=data_cfg.num_classes, temporal=temporal,
                          seed=seed)
    if artifact_path is not None:
        # fail BEFORE training, not after hours of it: the artifact packs
        # the last stage the run will reach, which must be quantized
        last = stop_after if stop_after is not None else stages[-1].name
        last_stage = {s.name: s for s in stages}.get(last)
        if last_stage is not None and last_stage.ccfg.quant_spec is None:
            raise ValueError(
                f"--artifact needs the run to end on a quantized stage; "
                f"it would end on {last!r} (weight_bits unset) — drop "
                f"--stop-after or export later with --resume --artifact")
    pipe = CompressionPipeline(stages, stream, workdir=workdir, steps=steps,
                               batch_size=batch_size, log_every=log_every,
                               metric_sink=metric_sink, device=device)
    results = pipe.run(resume=resume, stop_after=stop_after)
    if artifact_path is not None:
        final = results[-1]
        feats = torch.from_numpy(stream.batch(batch_size, step=0)["features"])
        scale = spike_ops.quantize_input(feats.to(pipe.device),
                                         final.cfg.input_bits)[1]
        export_artifact(final, artifact_path, input_scale=scale)
        log.info("wrote deployment artifact to %s", artifact_path)
    return results


# ------------------------------------------------------------------- CLI


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run the paper's compression recipe (resumable)")
    ap.add_argument("--steps", type=int, default=300, help="steps per stage")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hidden-base", type=int, default=256)
    ap.add_argument("--hidden-pruned", type=int, default=128)
    ap.add_argument("--frames", type=int, default=100,
                    help="synthetic utterance length")
    ap.add_argument("--num-classes", type=int, default=1920)
    ap.add_argument("--no-temporal", action="store_true",
                    help="disable inherent temporal training")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="stage checkpoints + manifest live here")
    ap.add_argument("--resume", action="store_true",
                    help="restore finished stages from the workdir manifest")
    ap.add_argument("--stop-after", default=None, metavar="STAGE",
                    help="end the run after this stage (simulated kill)")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="pack the final QAT stage into an on-disk artifact")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    results = run_pipeline(
        steps=args.steps, batch_size=args.batch,
        hidden_base=args.hidden_base, hidden_pruned=args.hidden_pruned,
        data_cfg=SpeechDataConfig(frames=args.frames,
                                  num_classes=args.num_classes),
        temporal=not args.no_temporal, seed=args.seed,
        workdir=args.workdir, resume=args.resume, stop_after=args.stop_after,
        artifact_path=args.artifact, device=args.device)
    for r in results:
        log.info("stage %-14s fer=%.4f size=%.1f KB mmac_skip=%.2f",
                 r.name, r.error_rate, r.size_bytes / 1e3, r.mmac_skip)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
