"""One run of one cell: set-up, the measured window, the check, the line.

A run reads its cell from ``BENCHMARK.json`` (a configuration and a
traffic mix) and hands both to the configuration's family
(``families/<family>.py``, named in the configuration's file), which
draws the model and its inputs from the seed, builds and warms up the
program and serves the mix for ``--seconds``.  With the window closed,
the program's memory peak read and its state freed, the family holds the
window's answers against its plain reference.  The run prints the set-up's
phases, where the process ran, and the numbers compared beside their
limits on standard error, and one JSON object: the cell's end-to-end
metrics (``--trace 0``) or its per-layer metrics, read by
``metrics/<name>.py`` from the device trace, the spans and the program's
counters (``--trace 1``), with the numbers compared under ``checks``,
last.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from bench import families, traffic
from bench.devtrace import DeviceTrace, Spans

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


def family(cfg: dict):
    """The family module of the configuration ``cfg``."""
    if "family" not in cfg:
        raise RunError(f"configuration {cfg.get('name')!r} names no family")
    return families.load(cfg["family"])


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


def _smi(device: torch.device, field: str) -> str | None:
    """One field of ``nvidia-smi``'s query for the card; None where it gives
    none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out if out and not out.startswith("[") else None


def card(device: torch.device) -> dict:
    """The card's name and power limit, and the run's card count."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "power_limit": _smi(device, "power.limit") or "not read"}


# ---- the host: where the process runs, relative to the card

def parse_cpulist(text: str) -> set[int]:
    """The CPUs of a kernel cpulist such as ``0-3,8,10-11``."""
    cpus: set[int] = set()
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def cpulist(cpus) -> str:
    """``cpus`` as a kernel cpulist, in runs: ``{0, 1, 2, 5}`` -> ``0-2,5``."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c != run[-1] + 1:
            out.append(run)
            run = []
        run.append(c)
    if run:
        out.append(run)
    return ",".join(f"{r[0]}-{r[-1]}" if len(r) > 1 else f"{r[0]}"
                    for r in out)


def _read(path: Path) -> str | None:
    try:
        return path.read_text().strip()
    except OSError:
        return None


def cpu_nodes(sys_root: Path = Path("/sys")) -> dict[int, set[int]]:
    """NUMA node -> its CPUs; empty where the kernel shows no nodes."""
    out = {}
    for d in sorted((sys_root / "devices/system/node").glob("node[0-9]*")):
        text = _read(d / "cpulist")
        if text is not None:
            out[int(d.name[4:])] = parse_cpulist(text)
    return out


def card_sysfs(bus_id: str | None, sys_root: Path = Path("/sys")
               ) -> Path | None:
    """The card's PCI directory, from ``nvidia-smi``'s bus id
    (``00000000:18:00.0``, an 8-digit domain, where sysfs has 4)."""
    if not bus_id:
        return None
    bus = bus_id.lower()[-12:]
    path = sys_root / "bus/pci/devices" / bus
    return path if path.is_dir() else None


def host(bus_id: str | None, sys_root: Path = Path("/sys")) -> dict:
    """Where the process may run: ``host_cpus``, its CPU set, and
    ``host_node``, the NUMA nodes of those CPUs and the card's node (None
    where sysfs does not say)."""
    cpus = os.sched_getaffinity(0)
    nodes = cpu_nodes(sys_root)
    pci = card_sysfs(bus_id, sys_root)
    node = _read(pci / "numa_node") if pci is not None else None
    return {"host_cpus": cpulist(cpus),
            "host_node": {"cpus": sorted(n for n, s in nodes.items()
                                         if s & cpus),
                          "card": int(node) if node is not None else None}}


class Timeline:
    """Set-up's phases on the harness's clock (``time.monotonic``), from
    the process's start ``t_start``."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.phases: list[tuple[str, float]] = []

    def phase(self, name: str) -> None:
        """The phase ``name`` ends now."""
        self.phases.append((name, time.monotonic()))

    def durations(self, t0: float) -> list[tuple[str, float]]:
        """Each phase's seconds, and the rest up to the window's open
        ``t0``."""
        out, last = [], self.t_start
        for name, t in self.phases:
            out.append((name, t - last))
            last = t
        out.append(("to_window", t0 - last))
        return out


class Window:
    """The measured window, handed to a family's ``serve``: ``settle()``
    once set-up is done, then ``open(t0, t1)`` as the window opens and
    ``close()`` as it closes.  Settling starts the device trace, lets the
    card finish what set-up queued and moves set-up's objects out of the
    collector's way; opening and closing mark the trace's window.  After
    ``serve`` the harness refuses a run that skipped a step (``verify``)."""

    def __init__(self, seconds: float, device: torch.device,
                 trace: DeviceTrace | None, timeline: Timeline):
        self.seconds = seconds
        self.device, self.trace, self.timeline = device, trace, timeline
        self.settled = self.closed = False
        self.t0 = self.t1 = None

    def settle(self) -> None:
        if self.trace is not None:
            self.trace.start()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        gc.collect()
        gc.freeze()
        self.settled = True
        self.timeline.phase("settle")

    def open(self, t0: float, t1: float) -> None:
        if not self.settled:
            raise RunError("the window opened before set-up settled")
        self.t0, self.t1 = t0, t1
        if self.trace is not None:
            self.trace.open()

    def close(self) -> None:
        if self.t0 is None:
            raise RunError("the window closed before it opened")
        if self.trace is not None:
            self.trace.close()
        self.closed = True

    def verify(self) -> None:
        """Raise ``RunError`` unless the window was settled, opened and
        closed, and a trace's window has a length."""
        if not (self.settled and self.t0 is not None and self.closed):
            raise RunError(
                f"the family's serve left the window unfinished (settled "
                f"{self.settled}, opened {self.t0 is not None}, closed "
                f"{self.closed})")
        if self.trace is not None and not self.trace.t1 > self.trace.t0:
            raise RunError("the traced window has no length")


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", files: tuple | None = None,
        bench: dict | None = None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` is for
    the tests (the program's plain versions, no trace); ``files`` replaces
    ``cell_files``' (cell, configuration, mix, limits) and ``bench`` the
    manifest."""
    timeline = Timeline(t_start)
    timeline.phase("imports")
    bench = manifest() if bench is None else bench
    cell, cfg, mix, limits = files or cell_files(bench, workload)
    fam = family(cfg)
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

    # ---- set-up and the window
    spans = Spans(trace)
    dt = DeviceTrace() if trace else None
    setup = fam.build(cfg, mix, seed, dev, timeline)
    win = Window(window, dev, dt, timeline)
    got = fam.serve(setup, win, spans, timeline)
    win.verify()
    if dt is not None:
        dt.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e = dict(got.e2e, setup_s=win.t0 - t_start)
    setup.program = None
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check: the window's answers against the reference
    checks, correct, failed = fam.check(setup, got, limits, dev)

    # ---- metrics
    metrics = {}
    result_device = card(dev) if dev.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    result_device["memory_peak_bytes"] = int(peak)
    result_device.update(host(_smi(dev, "pci.bus_id")
                              if dev.type == "cuda" else None))
    breakdown = None
    if trace:
        ctx = dict(fam.context(setup, got), trace=dt)
        for m in cell_metrics(bench, workload, True):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_device["busy_s"] = dt.busy_s()
        result_device["window_s"] = dt.window_s
        breakdown = dt.breakdown(spans)
    else:
        for m in cell_metrics(bench, workload, False):
            if m["name"] not in e2e:
                raise RunError(f"the {cfg['family']} family gives no "
                               f"{m['name']} for {workload}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    print("set-up phases (s): " + ", ".join(
        f"{name} {s:.3f}" for name, s in timeline.durations(win.t0)),
        file=sys.stderr)
    for k, v in checks.items():
        print(f"{k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(got.attempted),
           "failed": int(failed), "metrics": metrics,
           "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
