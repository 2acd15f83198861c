"""The benchmarks' entry point: one entry per paper table/figure +
roofline summary, as ``benchmarks/run.py`` has them.

Prints ``name,us_per_call,derived`` CSV lines (us_per_call only for the
timed entries; analytic tables report 0).  ``--only SUBSTR`` restricts the
run to matching entries; ``--list`` prints the available names.  A
``--only`` that matches nothing exits 2 listing the available names.  The
timed entries run on ``--device`` (``cuda`` unless the caller asks for
``cpu``; no GPU raises): the rows of ``paper_tables.py``, each reaching
the kernels its docstring names through ``kernels/ops.py``.  The analytic
tables read ``paper_tables.RESULTS``; ``roofline_summary`` reads the dry
run's records (``benchmarks/roofline.py`` ``RESULTS``).

For persisted latency/throughput trajectories (rather than one-off CSV
rows), see ``loadgen.py`` / ``trajectory.py`` beside this module.

  python -m repro_torch.benchmarks.run [--only SUBSTR] [--list] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.benchmarks import paper_tables as T
from repro_torch.core.device import resolve_device

ANALYTIC = ("table1_dimensions", "fig12_model_size", "fig13_complexity",
            "fig14_error_ablation", "fig16_time_steps", "fig17_cycles",
            "fig18_sparsity", "table2_weight_access", "table3_power")

TIMED = (("bench_rsnn_forward", "bench_rsnn_forward"),
         ("bench_merged_spike_fc", "bench_kernels"),
         ("bench_sparse_fc", "bench_sparse_fc"),
         ("bench_nm_fc", "bench_nm_fc"),
         ("bench_stream_engine", "bench_stream_engine"),
         ("bench_stream_sharded", "bench_stream_sharded"),
         ("bench_stream_pipeline", "bench_stream_pipeline"),
         ("bench_artifact_roundtrip", "bench_artifact_roundtrip"),
         ("bench_megastep", "bench_megastep"),
         ("bench_delta", "bench_delta"),
         ("bench_spike_broadcast", "bench_spike_broadcast"))


def _emit(name: str, us: float, derived) -> None:
    print(f"{name},{us:.2f},{json.dumps(derived, default=str)}")


def all_names() -> tuple[str, ...]:
    """Every runnable bench name (the values ``--only`` matches against)."""
    return ANALYTIC + tuple(n for n, _ in TIMED) + ("roofline_summary",)


def list_entries() -> None:
    """Print every runnable bench name (the values ``--only`` matches)."""
    for name in ANALYTIC:
        print(f"{name}  [analytic]")
    for name, _ in TIMED:
        print(f"{name}  [timed]")
    print("roofline_summary  [derived]")


def _run_roofline() -> None:
    # roofline summary over the dry run's single-pod records
    try:
        from repro_torch.benchmarks import roofline

        rows = roofline.table("pod")
        ok = [r for r in rows if "roofline_fraction" in r]
        worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:3]
        _emit("roofline_summary", 0.0, {
            "cells": len(rows),
            "ok": len(ok),
            "worst": [f"{r['arch']}/{r['shape']}={r['roofline_fraction']:.4f}"
                      for r in worst]})
    except Exception as e:  # dry-run records absent or unreadable
        _emit("roofline_summary", 0.0, {"error": str(e)})


def main(only: str | None = None, device="cuda") -> int:
    """Run every entry whose name contains ``only`` (all when None), the
    timed ones on ``device``.

    Returns the number of entries run.  Zero matches exits 2 and lists
    the available names on stderr, before the device is resolved.  The
    roofline row goes through the same name match as every other entry.
    """
    matches = lambda name: not only or only in name  # noqa: E731
    selected = [n for n in all_names() if matches(n)]
    if only and not selected:
        print(f"error: --only {only!r} matches no benchmark entry; "
              f"available:", file=sys.stderr)
        for name in all_names():
            print(f"  {name}", file=sys.stderr)
        raise SystemExit(2)
    device = resolve_device(device)

    print("name,us_per_call,derived")
    for name in ANALYTIC:
        if not matches(name):
            continue
        rows, derived = getattr(T, name)()
        _emit(name, 0.0, {"rows": rows, **derived})

    for name, fn in TIMED:
        if not matches(name):
            continue
        us, d = getattr(T, fn)(device)
        _emit(name, us, d)

    if matches("roofline_summary"):
        _run_roofline()
    return len(selected)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Print the paper's tables, the timed rows and the "
                    "roofline summary as CSV")
    ap.add_argument("--only", default=None,
                    help="run only entries whose name contains this substring")
    ap.add_argument("--list", action="store_true",
                    help="print available bench names and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.list:
        list_entries()
    else:
        main(args.only, args.device)
    return 0


if __name__ == "__main__":
    cli()
