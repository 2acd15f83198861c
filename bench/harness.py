"""One run of one cell: set-up, the measured window, the check, the line.

A run reads its cell from ``BENCHMARK.json`` (a configuration and a
traffic mix), draws the model and the feature pool from the seed on the
card, writes the artifact, builds the program (``program.py``), warms it
up, serves the mix for ``--seconds`` (``drive.py``), and then, with the
window closed and the program's memory peak read and its state freed,
holds a seeded sample of the window's answers against the reference
(``reference/``).  It prints the numbers compared beside their limits on
standard error, and one JSON object: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics, read by ``metrics/<name>.py``
from the device trace, the harness's spans and the loop's counters
(``--trace 1``), with the numbers compared under ``checks``, last.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from bench import drive, traffic
from bench.devtrace import DeviceTrace, Spans
from bench.reference import compare, data
from bench.reference.model import Reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level names, compared whole
TRACE_SECONDS = 5.0  # a traced window is at most this long


class RunError(RuntimeError):
    """A run that cannot give a result; it prints none."""


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration, mix, limits) of ``workload``, each read from
    its own file by name."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = traffic.load(cell["traffic"])
    limits = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    return cell, cfg, mix, limits["limits"]


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones (by their ``workloads``, else by whether the cell
    reports the end-to-end metric they move)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process."""
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


def card(device: torch.device) -> dict:
    """The card's name and power limit, and the run's card count."""
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def fc_entries(cfg: dict, model: dict) -> int:
    """CSC entries a column of the stored FC (the densest column's kept
    count, which the layout pads every column to); 0 for a dense FC."""
    if cfg["precision"] != "int4":
        return 0
    keep = model["layers"]["fc_w"][2]
    return max(int(keep.sum(dim=0).max()), 1)


class Served:
    """What the window measured: the window, the loop's counters at its
    bounds, every harvested request's (t_harvest, frames), and in the open
    loop each due request's completion latency."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.open: dict = {}
        self.close: dict = {}
        self.harvests: list[tuple[float, int]] = []
        self.latency: dict[int, float] = {}  # open loop: sid -> seconds

    def in_window(self, t: float) -> bool:
        return self.t0 is not None and self.t0 <= t <= self.t1

    def frames(self) -> int:
        return sum(n for t, n in self.harvests if self.in_window(t))


def serve(loop, mix: dict, pool, seed: int, window: float, trace: bool
          ) -> tuple[Served, drive.Feed, DeviceTrace | None, Spans]:
    """Warm up (the open loop: with ``warmup_s`` of arrivals), then serve
    the mix over the window.  Returns what was measured, the feed (its
    sample and bookkeeping), the device trace and the spans; set-up ends
    as the window opens (``Served.t0``)."""
    spans = Spans(trace)
    collector = drive.Collector(loop, mix["check"], seed, mix["max_frames"])
    order = traffic.submission_order(len(pool), seed)
    dt = DeviceTrace() if trace else None
    got = Served()
    cls = drive.Backlog if mix["mode"] == "backlog" else drive.OpenLoop
    feed = cls(mix, loop, pool, order, collector, spans)

    def counters() -> dict:
        return {"dispatches": loop.dispatches, "host_syncs": loop.host_syncs,
                "frames_served": loop.frames_served,
                "step_s": feed.step_s}

    def on_open(t0, t1):
        got.t0, got.t1 = t0, t1
        if dt is not None:
            dt.open()
        got.open = counters()

    def on_close():
        got.close = counters()
        if dt is not None:
            dt.close()

    if mix["mode"] == "backlog":
        collector.on_harvest = lambda r: got.harvests.append(
            (r.t_harvest, len(r.frames)))
        collector.counts = lambda r: got.in_window(r.t_harvest)
        rate = feed.warm(mix["warmup_dispatches"])
        collector.stride_for(rate * window)
        _settle(loop, dt)
        feed.window(window, on_open, on_close)
    else:
        def harvest(r):
            got.harvests.append((r.t_harvest, len(r.frames)))
            if r.sid in feed.due:
                got.latency[r.sid] = r.t_harvest - feed.due[r.sid]

        collector.on_harvest = harvest
        collector.counts = lambda r: r.sid in feed.due
        warm = traffic.arrival_offsets(mix["rate"], mix["warmup_s"], seed, 0)
        offs = traffic.arrival_offsets(mix["rate"], window, seed, 1)
        collector.stride_for(len(offs))
        _settle(loop, dt)
        feed.run(warm, offs, mix["warmup_s"], window, mix["drain_s"],
                   on_open, on_close)
    loop.flush()
    collector.poll()
    if dt is not None:
        dt.stop()
    return got, feed, dt, spans


def _settle(loop, dt: DeviceTrace | None) -> None:
    """Start the trace, let the card finish what set-up queued, and move
    set-up's objects out of the collector's way."""
    if dt is not None:
        dt.start()
    if loop.engine.device.type == "cuda":
        torch.cuda.synchronize(loop.engine.device)
    gc.collect()
    gc.freeze()


def open_loop_latencies(got: Served, feed, mix: dict) -> list[float]:
    """Completion latency (s) of every due request, from its scheduled
    arrival to its harvest; one not harvested by the drain's end counts
    from its arrival to that end."""
    end = got.t1 + mix["drain_s"]
    return [got.latency.get(sid, end - due)
            for sid, due in feed.due.items()]


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", files: tuple | None = None,
        bench: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` is for
    the tests (the program's plain versions, no trace); ``files`` replaces
    ``cell_files``' (cell, configuration, mix, limits) and ``bench`` the
    manifest."""
    bench = manifest() if bench is None else bench
    cell, cfg, mix, limits = files or cell_files(bench, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} CUDA device(s); "
                           f"torch sees {torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    elif trace:
        raise RunError("a traced run needs the card")
    torch.set_num_threads(1)
    window = min(seconds, TRACE_SECONDS) if trace else float(seconds)

    # ---- set-up: model, features, artifact, program, warm-up
    model = data.weights(cfg, seed, dev)
    pool = traffic.Pool(mix, cfg, seed, dev)
    scale = data.input_scale(pool.frames, cfg["input_bits"])
    workdir = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        from bench import program

        loop = program.build(cfg, mix, model, scale, workdir, dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    got, feed, dt, spans = serve(loop, mix, pool, seed, window, trace)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sample = feed.collector.sample
    sid_utt = feed.sid_utt
    if mix["mode"] == "backlog":
        attempted = sum(1 for t, _ in got.harvests if got.in_window(t))
        e2e = {"frames_per_s": got.frames() / window}
        missing_due = 0
    else:
        lat = open_loop_latencies(got, feed, mix)
        attempted = len(feed.due)
        missing_due = attempted - len(got.latency)
        e2e = {"completion_p95_ms": 1e3 * traffic.nearest_rank(lat, 95)}
        late = feed.late_s or [0.0]
        print(f"open loop: {attempted} due, {missing_due} not harvested by "
              f"the drain's end; completion p50 "
              f"{1e3 * traffic.nearest_rank(lat, 50):.3f} ms p95 "
              f"{e2e['completion_p95_ms']:.3f} ms; generator late p50 "
              f"{1e3 * traffic.nearest_rank(late, 50):.3f} ms max "
              f"{1e3 * max(late):.3f} ms", file=sys.stderr)
    e2e["setup_s"] = got.t0 - t_start
    del loop, feed
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check: the window's sample against the reference
    streams = [pool.utterance(sid_utt[sid]) for sid, _ in sample]
    served = [logits for _, logits in sample]
    ref = Reference(cfg, model, "exact", dev)
    cmp = compare.compare(ref, streams, served, scale)
    checks = {
        "diverged_frames_pct": {"value": cmp["diverged_frames_pct"],
                                "limit": limits["diverged_frames_pct"]},
        "missing_streams": {"value": cmp["missing_streams"], "limit": 0},
        "checked_streams": {"value": cmp["checked_streams"],
                            "limit": limits["min_checked_streams"]},
    }
    correct = (cmp["diverged_frames_pct"] <= limits["diverged_frames_pct"]
               and cmp["missing_streams"] == 0
               and cmp["checked_streams"] >= limits["min_checked_streams"])

    # ---- metrics
    metrics = {}
    result_device = card(dev) if dev.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    result_device["memory_peak_bytes"] = int(peak)
    breakdown = None
    if trace:
        ctx = {"cfg": cfg, "mix": mix, "trace": dt, "open": got.open,
               "close": got.close, "macs_per_frame": cmp["macs_per_frame"],
               "fc_entries": fc_entries(cfg, model)}
        for m in cell_metrics(bench, workload, True):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = dt.busy_s()
        result_device["window_s"] = dt.window_s
        breakdown = dt.breakdown(spans)
    else:
        for m in cell_metrics(bench, workload, False):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    lines = [f"{k}: {v['value']} (limit {v['limit']})"
             for k, v in checks.items()]
    print(f"checked {cmp['checked_streams']} streams, "
          f"{cmp['checked_frames']} frames; {cmp['diverged_streams']} "
          f"streams diverged", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(missing_due + cmp["missing_streams"]),
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
