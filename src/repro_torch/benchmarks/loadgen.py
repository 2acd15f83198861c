"""Closed/open-loop load generator over the port's streaming slot loops
(``benchmarks/loadgen.py``'s counterpart, inside the package).

``repro_torch/benchmarks/run.py`` times single kernels and loops in
isolation; this
module measures what the paper actually claims — a real-time serving
envelope under load (frame-rate operation at bounded latency) — the way
the edge-ASR literature evaluates it (EdgeDRNN, "Optimizing Speech
Recognition For The Edge"): tail latency and sustained throughput under a
stream of arrivals, not single-call microseconds.

Harness shape
-------------
* **Workload.**  A deterministic, fully seeded stream population: ``N``
  utterances with lengths drawn uniform in ``[min_frames, max_frames]``
  and Poisson arrivals at a configurable rate (inter-arrival gaps drawn
  ``Exp(1/rate)`` from the same seeded generator).  Nothing in the sweep
  *identity* reads the wall clock — re-running a cell replays the exact
  same frames, lengths, and arrival offsets.
* **Closed loop** (``rate=None``): every stream is queued at ``t=0`` and
  the loop drains flat out.  This measures the service ceiling: throughput
  in frames/s, streams/s, and the per-frame (per-``step_once``) latency
  distribution under full slot occupancy.  On the card a pipelined loop's
  ``step_once`` can return before the device finishes the step, so its
  samples are the host's time for a step; a run's wall time ends after
  ``flush``, which waits for every step.
* **Open loop** (``rate>0``): arrivals are replayed against the monotonic
  clock; the harness submits each stream when its offset elapses and steps
  the loop in between.  Per-stream latency comes from the lifecycle
  timestamps ``serving/stream.py`` stamps at submit/slot-fill/harvest
  (completion = ``t_harvest - t_submit``; queue wait =
  ``t_start - t_submit``).
* **Saturation.**  The max arrival rate with bounded queue growth: probe
  open-loop runs bracket the closed-loop service rate and bisect on the
  bounded-backlog predicate (peak submit-queue depth ``<= max(2*slots,
  4)``).  Probes and verdicts are recorded per cell.
* **Warm-up exclusion.**  Each cell serves a short throwaway workload
  first (first-refill paths; the loop captured its step graph at
  construction), synchronizes the card, then clears metrics; no warm-up
  sample enters the stats.
* **Percentiles** are nearest-rank (deterministic on small samples — see
  ``nearest_rank``), reported as p50/p95/p99.

Results are written as a schema-versioned ``BENCH_<n>.json`` (machine
fingerprint with the card's name and power limit, git SHA, per-cell stats
over the ``{slots x pipeline_depth x layout(csc,nm) x
backend(jnp,pallas,fused,delta,spike) x chunk_frames x mesh}`` sweep,
measured sparsity from the live ``SparsityCounters``) into
``results/loadgen_torch/`` — the trajectory that ``trajectory.py compare``
beside this module diffs.  The backend axis puts the single-launch
mega-step (``kernels/megastep.py``, K6) in the trajectory next to the
per-op ``jnp`` (plain PyTorch) and ``pallas`` (the CUDA kernels) tables;
the chunk_frames axis adds frame-chunked dispatch with a traced
``dispatches_per_frame`` stat.  The engine is the reference's in-process
int4 model with its FC pruned 2:4 (``sparse_fc``): ``pallas`` reaches K1,
K2 and K4 (``csc``) or K5 (``nm``), ``fused`` K6, ``delta`` K8 and K10,
``spike`` K9, K10 and K4 or K5, ``jnp`` no kernel.  The sweep runs on
``--device`` (``cuda`` unless the caller asks for ``cpu``; no GPU
raises).

CLI::

    python -m repro_torch.benchmarks.loadgen --smoke --device cpu
    python -m repro_torch.benchmarks.loadgen --slots 256 --depths 0,2 \
        --layouts csc,nm --backends jnp,pallas,fused --chunks 1,4
    python -m repro_torch.benchmarks.trajectory compare \
        results/loadgen_torch/BENCH_1.json   # then diff it
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.benchmarks import trajectory
from repro_torch.benchmarks.paper_tables import _seeded_params, _sync
from repro_torch.core.compression import (CompressionConfig, PruneSpec,
                                          init_compression)
from repro_torch.core.device import resolve_device
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.tree import tree_map
from repro_torch.serving.sharded import ShardedStreamLoop
from repro_torch.serving.stream import CompiledRSNN, EngineConfig, StreamLoop

ROOT = Path(__file__).resolve().parents[3]
BENCH_INDEX = 1  # the port's first trajectory point: BENCH_1.json
INPUT_SCALE = 0.05  # static 8-bit calibration used across the benches
LAYOUT_TAGS = {"csc": "csc", "nm": "nm_group"}
BACKENDS = ("jnp", "pallas", "fused", "delta",
            "spike")  # sweepable engine backends


# ------------------------------------------------------------- percentiles


def nearest_rank(samples, p: float) -> float:
    """Nearest-rank percentile: the smallest sample such that at least
    ``p`` percent of the samples are <= it (rank ``ceil(p/100 * n)``,
    1-indexed, clamped to the first sample for tiny ``p``).

    No interpolation, so the result is always an observed sample and the
    definition is exact on the small-n distributions a smoke run produces.

    >>> nearest_rank([10.0, 20.0, 30.0, 40.0], 50)
    20.0
    >>> nearest_rank([10.0, 20.0, 30.0, 40.0], 99)
    40.0
    >>> nearest_rank([7.0], 1)
    7.0
    """
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("no samples")
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[rank - 1]


def latency_stats(samples) -> dict:
    """p50/p95/p99 + mean/max summary of a latency sample list."""
    xs = [float(x) for x in samples]
    if not xs:
        return {"n": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "mean": 0.0, "max": 0.0}
    return {"n": len(xs),
            "p50": round(nearest_rank(xs, 50), 3),
            "p95": round(nearest_rank(xs, 95), 3),
            "p99": round(nearest_rank(xs, 99), 3),
            "mean": round(sum(xs) / len(xs), 3),
            "max": round(max(xs), 3)}


# ---------------------------------------------------------------- workload


@dataclasses.dataclass(frozen=True)
class Workload:
    """A deterministic stream population (see module docstring).

    The sweep identity is fully determined by these fields: utterance
    frames, lengths, and arrival offsets all come from
    ``np.random.default_rng(seed)`` — no wall-clock randomness.
    """

    seed: int = 0
    num_streams: int = 16
    min_frames: int = 12
    max_frames: int = 48
    rate: float | None = None  # stream arrivals per second; None = closed

    def materialize(self, input_dim: int):
        """-> (utterances, arrival_offsets_seconds)."""
        rng = np.random.default_rng(self.seed)
        lens = rng.integers(self.min_frames, self.max_frames + 1,
                            self.num_streams)
        utts = [0.5 * rng.normal(size=(int(t), input_dim)).astype(np.float32)
                for t in lens]
        if self.rate is None:
            offsets = np.zeros(self.num_streams)
        else:
            offsets = np.cumsum(rng.exponential(1.0 / self.rate,
                                                self.num_streams))
        return utts, offsets

    @property
    def mean_frames(self) -> float:
        return (self.min_frames + self.max_frames) / 2.0

    def identity(self) -> dict:
        return {"seed": self.seed, "num_streams": self.num_streams,
                "min_frames": self.min_frames, "max_frames": self.max_frames}


# ------------------------------------------------------------ engine/loops


def build_engine(cfg: RSNNConfig, layout: str, seed: int = 0,
                 backend: str = "jnp",
                 device: torch.device | str = "cuda") -> CompiledRSNN:
    """Packed int4 engine on ``device`` whose pruned FC readout is stored
    in ``layout``.  The float parameters come from the draw hook
    ``_seeded_params`` (``paper_tables``': the CPU generator, so the card
    and the CPU serve one model) and move to ``device``.

    Both sweep layouts use the *same* 2:4 N:M mask (equal nnz, bit-equal
    logits), so the csc-vs-nm axis isolates the storage layout, not the
    sparsity pattern.  The backend axis isolates dispatch structure:
    per-op tables (``jnp``/``pallas``) vs the single-launch mega-step
    (``fused``); on the CPU every backend runs the plain versions.
    """
    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), _seeded_params(cfg, seed))
    spec = PruneSpec(kind="nm", n=2, m=4, layout=LAYOUT_TAGS[layout])
    ccfg = CompressionConfig(weight_bits=4, prune_specs=(("fc_w", spec),))
    return CompiledRSNN(
        cfg, params,
        EngineConfig(backend=backend, precision="int4", sparse_fc=True,
                     input_scale=INPUT_SCALE),
        ccfg=ccfg, cstate=init_compression(params, ccfg), device=device)


def build_loop(engine: CompiledRSNN, slots: int, depth: int, mesh: int,
               max_frames: int, chunk: int = 1) -> StreamLoop:
    """One sweep cell's loop: single-device StreamLoop at ``mesh == 1``,
    ShardedStreamLoop over the first ``mesh`` devices of the engine's type
    otherwise (on the CPU, ``mesh`` shards of the one CPU device).  On the
    card the loop captures its step as one CUDA graph at construction."""
    ring = max(max_frames, 8)
    # the pipelined chunked contract requires ring % chunk == 0 (a live
    # stream must never idle mid-chunk on ring capacity)
    ring = (ring + chunk - 1) // chunk * chunk
    if mesh == 1:
        return StreamLoop(engine, batch_slots=slots, pipeline_depth=depth,
                          ring_frames=ring, chunk_frames=chunk)
    if engine.device.type == "cuda":
        count = torch.cuda.device_count()
        if mesh > count:
            raise ValueError(f"mesh size {mesh} exceeds the {count} local "
                             f"devices")
        devices = [torch.device("cuda", i) for i in range(mesh)]
    else:
        devices = [engine.device] * mesh
    return ShardedStreamLoop(engine, batch_slots=slots, devices=devices,
                             max_frames=ring, pipeline_depth=depth,
                             ring_frames=ring, chunk_frames=chunk)


def warm(loop: StreamLoop, input_dim: int, frames: int = 4,
         streams: int = 2) -> None:
    """Warm-up exclusion: serve a throwaway workload (first refill/reset
    paths and pinned buffers), synchronize the card so no warm-up work is
    still queued, then zero every metric and drop the finished records so
    nothing from warm-up enters the stats.  A final ``gc.collect()``
    drains the garbage warm-up piles up — otherwise a collection pause
    (tens of ms after a long in-process sweep) lands on the first
    measured dispatch and pollutes the p99."""
    rng = np.random.default_rng(12345)
    for _ in range(streams):
        loop.submit(0.5 * rng.normal(size=(frames, input_dim))
                    .astype(np.float32))
    loop.run()
    _sync(loop.engine.device)
    loop.finished.clear()
    loop.reset_metrics()
    gc.collect()


# ------------------------------------------------------------- run loops


@dataclasses.dataclass
class RunResult:
    streams: int
    frames: int
    wall_s: float
    step_us: list  # per-step_once wall time (per-frame latency samples)
    completion_ms: list  # t_harvest - t_submit per stream
    queue_wait_ms: list  # t_start - t_submit per stream
    max_backlog: int  # peak submit-queue depth observed
    steps: int
    host_syncs: int
    dispatches: int  # device step dispatches (1/frame unchunked, ~1/C chunked)
    frames_served: int  # real (non-idle) frames advanced across dispatches

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def streams_per_s(self) -> float:
        return self.streams / self.wall_s if self.wall_s > 0 else 0.0


def run_workload(loop: StreamLoop, wl: Workload) -> RunResult:
    """Serve one workload to completion and collect latency samples.

    ``step_us`` is the wall time of each ``step_once`` that made progress;
    the run's wall time ends after ``flush``, which retires every step.
    Closed loop (``wl.rate is None``): everything is submitted at ``t=0``.
    Open loop: each stream is submitted once its Poisson offset elapses on
    the loop's monotonic clock; the harness idles (short sleeps) when the
    loop is drained but arrivals remain.

    The collector is disabled for the duration of the measured loop (and
    re-enabled after): a cyclic-GC pass triggered mid-run charges tens of
    ms to whichever dispatch it lands on, which dominates the p99 of a
    sub-ms cell.  Runs last seconds, so the deferred collection is cheap.
    """
    utts, offsets = wl.materialize(loop.engine.cfg.input_dim)
    clock = loop.clock
    step_us: list = []
    max_backlog = 0
    i, n = 0, len(utts)
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        t0 = clock()
        while True:
            now = clock() - t0
            while i < n and offsets[i] <= now:
                loop.submit(utts[i])
                i += 1
                max_backlog = max(max_backlog, len(loop.queue))
            t1 = clock()
            progressed = loop.step_once()
            if progressed:
                step_us.append((clock() - t1) * 1e6)
            elif i >= n:
                break
            else:  # drained, but arrivals remain: idle until next offset
                gap = offsets[i] - (clock() - t0)
                if gap > 0:
                    time.sleep(min(gap, 5e-4))
        loop.flush()
        wall = clock() - t0
    finally:
        if gc_was_enabled:
            gc.enable()
    done = list(loop.finished)
    return RunResult(
        streams=len(done),
        frames=sum(len(r.frames) for r in done),
        wall_s=wall,
        step_us=step_us,
        completion_ms=[(r.t_harvest - r.t_submit) * 1e3 for r in done],
        queue_wait_ms=[(r.t_start - r.t_submit) * 1e3 for r in done],
        max_backlog=max_backlog,
        steps=loop.steps,
        host_syncs=loop.host_syncs,
        dispatches=loop.dispatches,
        frames_served=loop.frames_served)


def _fresh(loop: StreamLoop) -> None:
    loop.finished.clear()
    loop.reset_metrics()


def find_saturation(loop: StreamLoop, wl: Workload, service_rate: float,
                    iters: int) -> dict:
    """Max arrival rate with bounded queue growth.

    Brackets the closed-loop service rate (probe below at 0.7x, above at
    1.6x), then bisects ``iters`` times on the bounded-backlog predicate.
    Every probe replays a seeded Poisson arrival schedule (offset seed =
    workload seed + 1 so probes don't alias the closed-loop frames).
    """
    bound = max(2 * loop.slots, 4)

    def probe(rate: float) -> dict:
        _fresh(loop)
        res = run_workload(
            loop, dataclasses.replace(wl, rate=rate, seed=wl.seed + 1))
        return {"rate_streams_per_s": round(rate, 3),
                "max_backlog": res.max_backlog,
                "bounded": res.max_backlog <= bound,
                "completion_ms_p99": latency_stats(res.completion_ms)["p99"]}

    lo, hi = 0.7 * service_rate, 1.6 * service_rate
    probes = [probe(lo), probe(hi)]
    if not probes[0]["bounded"]:
        lo, hi = 0.2 * service_rate, lo
        probes.append(probe(lo))
    best = max((p["rate_streams_per_s"] for p in probes if p["bounded"]),
               default=0.0)
    worst = min((p["rate_streams_per_s"] for p in probes
                 if not p["bounded"]), default=None)
    if worst is not None:
        lo, hi = best, worst
        for _ in range(max(iters, 0)):
            mid = (lo + hi) / 2.0
            p = probe(mid)
            probes.append(p)
            if p["bounded"]:
                lo = best = max(best, mid)
            else:
                hi = mid
    else:  # never saturated within the probed range: report the top probe
        best = max(best, hi)
    return {"streams_per_s": round(best, 3),
            "backlog_bound": bound,
            "probes": probes}


# -------------------------------------------------------------- deque A/B


def deque_refill_ab(n: int = 10000) -> dict:
    """Pinned-size A/B of the SlotScheduler refill fix: drain an ``n``-deep
    FIFO one request per refill, the pre-fix way (``list.pop(0)``, O(n) per
    pop -> quadratic) vs the deployed ``deque.popleft()`` (O(1)).  The
    identity (``n``) is fixed; only the measured microseconds vary by
    machine.  Documented in the BENCH JSON's derived notes."""
    items = list(range(n))

    q_list = list(items)
    t0 = time.perf_counter()
    while q_list:
        q_list.pop(0)
    list_us = (time.perf_counter() - t0) * 1e6

    q_deque = collections.deque(items)
    t0 = time.perf_counter()
    while q_deque:
        q_deque.popleft()
    deque_us = (time.perf_counter() - t0) * 1e6

    return {"queued_streams": n,
            "list_pop0_us": round(list_us, 1),
            "deque_popleft_us": round(deque_us, 1),
            "speedup": round(list_us / max(deque_us, 1e-9), 1),
            "note": "pre-fix SlotScheduler.queue drained with list.pop(0) "
                    "(O(n) per refill); deployed deque.popleft() is O(1)"}


# ------------------------------------------------------------------ sweep


def _sparsity_dict(loop: StreamLoop) -> dict:
    prof = loop.sparsity_profile()
    return {"input_bit_density": round(prof.input_bit_density, 4),
            "l0_density": [round(d, 4) for d in prof.l0_density],
            "l1_density": [round(d, 4) for d in prof.l1_density],
            "fc_union_density": round(prof.fc_union_density, 4),
            "delta_input_density": round(prof.delta_input_density, 4)}


def run_cell(engine: CompiledRSNN, layout: str, backend: str, slots: int,
             depth: int, mesh: int, wl: Workload, sat_iters: int,
             chunk: int = 1, latency_reps: int = 3) -> dict:
    """One sweep cell: warm-up, closed-loop service measurement, open-loop
    run at 70% of the measured service rate, saturation search.

    The closed-loop measurement repeats ``latency_reps`` times and keeps
    the repetition with the lowest p50 — the repeat-and-take-best
    estimator (``timeit``'s rationale): on a contended host the *fastest*
    replay is the one least polluted by external noise, and the workload
    itself is fully seeded, so repetitions are identical work.  The
    sparsity counters and MMAC accounting are deterministic per workload
    and thus rep-invariant.
    """
    loop = build_loop(engine, slots, depth, mesh, wl.max_frames, chunk)
    warm(loop, engine.cfg.input_dim)

    closed = run_workload(loop, wl)
    sparsity = _sparsity_dict(loop)
    mmac = loop.mmac_per_second()
    for _ in range(max(1, latency_reps) - 1):
        _fresh(loop)
        rep = run_workload(loop, wl)
        if nearest_rank(rep.step_us, 50) < nearest_rank(closed.step_us, 50):
            closed = rep
    service_rate = closed.streams_per_s

    _fresh(loop)
    open_res = run_workload(
        loop, dataclasses.replace(wl, rate=0.7 * service_rate,
                                  seed=wl.seed + 1))
    sat = find_saturation(loop, wl, service_rate, sat_iters)

    return {
        "key": f"slots{slots}-depth{depth}-{layout}-{backend}"
               f"-chunk{chunk}-mesh{mesh}",
        "slots": slots,
        "pipeline_depth": depth,
        "layout": layout,
        "backend": backend,
        "chunk_frames": chunk,
        "mesh": mesh,
        "streams": closed.streams,
        "frames": closed.frames,
        "dispatches_per_frame": round(
            closed.dispatches / max(closed.frames_served, 1), 4),
        "frame_latency_us": latency_stats(closed.step_us),
        "stream_completion_ms": latency_stats(open_res.completion_ms),
        "queue_wait_ms": latency_stats(open_res.queue_wait_ms),
        "open_loop_rate_streams_per_s": round(0.7 * service_rate, 3),
        "throughput_frames_per_s": round(closed.frames_per_s, 1),
        "service_streams_per_s": round(service_rate, 3),
        "saturation_streams_per_s": sat["streams_per_s"],
        "saturation": sat,
        "host_syncs_per_frame": round(
            closed.host_syncs / max(closed.frames, 1), 3),
        "measured_mmac_per_s": round(mmac, 3),
        "sparsity": sparsity,
    }


def card_name_and_power_limit(index: int = 0) -> tuple[str, str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[index]
    name, limit = line.rsplit(",", 1)
    return name.strip(), limit.strip()


def machine_fingerprint(device: torch.device | str = "cuda") -> dict:
    """The host, the framework and the device the sweep ran on; on the card
    also its name and power limit, so every number in a document stands
    beside them."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    fp = {"platform": platform.platform(),
          "python": platform.python_version(),
          "cpu_count": os.cpu_count() or 0,
          "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_platform": device.type,
          "device_count": torch.cuda.device_count() if cuda else 1}
    if cuda:
        fp["device_name"], fp["power_limit"] = card_name_and_power_limit(
            device.index or 0)
    return fp


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except Exception:
        return "unknown"


def run_sweep(cfg: RSNNConfig, slots_list, depths, layouts, meshes,
              wl: Workload, sat_iters: int, backends=("jnp",),
              chunks=(1,), device: torch.device | str = "cuda",
              latency_reps: int = 3) -> dict:
    """The ``{slots x depth x layout x backend x chunk x mesh}`` sweep on
    ``device`` -> BENCH doc; each cell's closed loop repeated
    ``latency_reps`` times (``run_cell``)."""
    device = resolve_device(device)
    cells = []
    for layout in layouts:
        for backend in backends:
            engine = build_engine(cfg, layout, backend=backend,
                                  device=device)
            for mesh in sorted(meshes):
                for slots in slots_list:
                    for depth in depths:
                        for chunk in chunks:
                            print(f"[loadgen] cell slots={slots} "
                                  f"depth={depth} layout={layout} "
                                  f"backend={backend} chunk={chunk} "
                                  f"mesh={mesh} ...", flush=True)
                            cells.append(run_cell(engine, layout, backend,
                                                  slots, depth, mesh, wl,
                                                  sat_iters, chunk,
                                                  latency_reps))
    ab = deque_refill_ab()
    doc = {
        "schema_version": trajectory.SCHEMA_VERSION,
        "bench": f"BENCH_{BENCH_INDEX}",
        "kind": "rsnn-serving-loadgen",
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "git_sha": git_sha(),
        "machine": machine_fingerprint(device),
        # backend is a CELL axis since schema v2, not a model field —
        # trajectory's model-identity comparison ignores it either way, so
        # v2 docs stay comparable against the v1 baseline
        "model": {"input_dim": cfg.input_dim, "hidden_dim": cfg.hidden_dim,
                  "fc_dim": cfg.fc_dim, "num_ts": cfg.num_ts,
                  "precision": "int4", "fc_prune": "2:4"},
        "workload": wl.identity(),
        "latency_definitions": {
            "frame_latency_us": "wall time of one step_once (one dispatch: "
                                "one frame advanced across all active slots "
                                "unchunked, up to chunk_frames frames per "
                                "slot chunked), closed loop, warm-up "
                                "excluded; on the card a pipelined "
                                "step_once may return before the device "
                                "finishes its step, so this is the host's "
                                "time for the step",
            "dispatches_per_frame": "device dispatches / non-idle frames "
                                    "served, closed loop; one dispatch "
                                    "covers every active slot, so ~1/slots "
                                    "unchunked and ~1/(slots*chunk_frames) "
                                    "chunked — chunking divides it by C",
            "stream_completion_ms": "t_harvest - t_submit per stream, open "
                                    "loop at 0.7x the measured service rate",
            "queue_wait_ms": "t_start - t_submit per stream, same open-"
                             "loop run",
            "percentiles": "nearest-rank (loadgen.nearest_rank)",
        },
        "cells": cells,
        "derived": {
            "deque_refill_ab": ab,
            "notes": [
                "saturation = max Poisson arrival rate with peak queue "
                "depth <= max(2*slots, 4); probes bracket the closed-loop "
                "service rate and bisect",
                f"deque refill fix: draining {ab['queued_streams']} queued "
                f"streams costs {ab['deque_popleft_us']}us with "
                f"deque.popleft() vs {ab['list_pop0_us']}us with the "
                f"pre-fix list.pop(0) ({ab['speedup']}x) — the quadratic "
                "refill cost is gone",
            ],
        },
    }
    errors = trajectory.validate_doc(doc)
    if errors:
        raise RuntimeError("generated BENCH doc fails its own schema: "
                           + "; ".join(errors))
    return doc


# -------------------------------------------------------------------- CLI


def _parse_ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x != ""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sweep: 2 slots, depths {0,2}, csc+nm, "
                         "jnp+fused+delta+spike, chunks {1,4} on the fused "
                         "backend, mesh 1, small model")
    ap.add_argument("--out", default=str(
        trajectory.RESULTS / f"BENCH_{BENCH_INDEX}.json"))
    ap.add_argument("--slots", default="1,4")
    ap.add_argument("--depths", default="0,2")
    ap.add_argument("--layouts", default="csc,nm")
    ap.add_argument("--backends", default="jnp,fused",
                    help=f"engine backends to sweep, from {BACKENDS}")
    ap.add_argument("--chunks", default="1,8",
                    help="chunk_frames values to sweep (frames staged per "
                         "device dispatch; 1 = classic per-frame stepping)")
    ap.add_argument("--meshes", default="1")
    ap.add_argument("--streams", type=int, default=24)
    ap.add_argument("--min-frames", type=int, default=12)
    ap.add_argument("--max-frames", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sat-iters", type=int, default=3,
                    help="bisection steps of the saturation search")
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--fc-dim", type=int, default=1920)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu, "
                         "where every backend runs the plain versions")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = RSNNConfig(input_dim=20, hidden_dim=64, fc_dim=192, num_ts=2)
        slots_list, depths, meshes = [2], [0, 2], [1]
        layouts = ["csc", "nm"]
        backends = ["jnp", "fused", "delta", "spike"]
        # chunk 4 next to the per-frame baseline keeps the
        # dispatches_per_frame 1 -> 1/C amortization on the trajectory for
        # every backend (the loops' logits are bit-equal across chunks;
        # this traces the perf side)
        chunks = [1, 4]
        wl = Workload(seed=args.seed, num_streams=8, min_frames=8,
                      max_frames=20)
        sat_iters = 1
    else:
        cfg = RSNNConfig(hidden_dim=args.hidden, fc_dim=args.fc_dim)
        slots_list = _parse_ints(args.slots)
        depths = _parse_ints(args.depths)
        meshes = _parse_ints(args.meshes)
        chunks = _parse_ints(args.chunks)
        layouts = [s.strip() for s in args.layouts.split(",") if s.strip()]
        backends = [s.strip() for s in args.backends.split(",") if s.strip()]
        wl = Workload(seed=args.seed, num_streams=args.streams,
                      min_frames=args.min_frames, max_frames=args.max_frames)
        sat_iters = args.sat_iters
    for lay in layouts:
        if lay not in LAYOUT_TAGS:
            ap.error(f"unknown layout {lay!r}; choose from "
                     f"{sorted(LAYOUT_TAGS)}")
    for bk in backends:
        if bk not in BACKENDS:
            ap.error(f"unknown backend {bk!r}; choose from {BACKENDS}")
    if not chunks or any(c < 1 for c in chunks):
        ap.error(f"--chunks must be positive integers, got {chunks}")

    doc = run_sweep(cfg, slots_list, depths, layouts, meshes, wl, sat_iters,
                    backends=backends, chunks=chunks, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=2) + "\n")
    print(f"[loadgen] wrote {out} ({len(doc['cells'])} cells, "
          f"schema v{doc['schema_version']})")
    for c in doc["cells"]:
        print(f"  {c['key']}: frame p50={c['frame_latency_us']['p50']}us "
              f"p99={c['frame_latency_us']['p99']}us "
              f"sat={c['saturation_streams_per_s']} streams/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
