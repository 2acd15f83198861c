"""A cell of the benchmark shrunk to run on the CPU in a second: the same
files, read by name, with the widths, slots, chunk, pool and window cut,
so that the tests drive the harness end to end through the program's
plain versions.  The float dictation cell and the open-loop commands
cell, whose files are kept while ``BENCHMARK.json`` leaves them out (on
the card their runs spread more than a bound holds, ``PERF.md``), are
driven the same way."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from bench import harness  # noqa: E402

torch.set_num_threads(1)

CELLS = ("rsnn-pruned-int4.dictation-backlog",
         "rsnn-baseline-float.dictation-backlog",
         "rsnn-pruned-int4.commands-open")
FLOAT = {"name": "rsnn-baseline-float.dictation-backlog",
         "config": "rsnn-baseline-float", "traffic": "dictation-backlog",
         "chips": 1}
OPEN = {"name": "rsnn-pruned-int4.commands-open", "config": "rsnn-pruned-int4",
        "traffic": "commands-open", "chips": 1}
P95 = {"name": "completion_p95_ms", "unit": "ms", "better": "lower",
       "bound": 0.25, "source": "host_clock", "workloads": [OPEN["name"]]}


def manifest() -> dict:
    """``BENCHMARK.json`` with the cells it leaves out put back."""
    bench = harness.manifest()
    names = {w["name"] for w in bench["workloads"]}
    if FLOAT["name"] not in names:
        bench["configs"].append({"name": "rsnn-baseline-float",
                                 "file": "bench/configs/"
                                         "rsnn-baseline-float.json"})
        bench["workloads"].append(FLOAT)
        for m in bench["end_to_end"]:
            if m["name"] == "frames_per_s":
                m["workloads"].append(FLOAT["name"])
    if OPEN["name"] not in names:
        bench["workloads"].append(OPEN)
        bench["end_to_end"].append(P95)
    return bench


def tiny_files(cell_name: str, hidden: int = 16, fc: int = 32) -> tuple:
    """(cell, configuration, mix, limits) of ``cell_name``, shrunk."""
    cell, cfg, mix, limits = harness.cell_files(manifest(), cell_name)
    cfg = dict(cfg, hidden_dim=hidden, fc_dim=fc)
    mix = dict(mix, slots=8, chunk_frames=4, pool=48, check=16,
               min_frames=12, max_frames=40, ring_frames=40)
    if mix["mode"] == "backlog":
        mix.update(backlog=8, warmup_dispatches=4)
    else:
        mix.update(rate=100.0, warmup_s=0.3, drain_s=20.0)
    return cell, cfg, mix, dict(limits, min_checked_streams=8)


def tiny_run(cell_name: str, seed: int = 2 ** 31 + 11,
             seconds: float = 0.8) -> dict:
    """One run of the shrunk cell on the CPU."""
    import time

    return harness.run(cell_name, seed, seconds, False, time.monotonic(),
                       device="cpu", files=tiny_files(cell_name),
                       bench=manifest())
