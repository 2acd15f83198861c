"""Perf-trajectory tooling over the load generator's ``BENCH_*.json``
documents (``benchmarks/trajectory.py``'s counterpart, inside the
package).

``repro_torch/benchmarks/loadgen.py`` writes one schema-versioned
``BENCH_<n>.json`` a run (per-cell latency percentiles, saturation
throughput, measured sparsity, machine fingerprint with the card's name
and power limit, git SHA) into ``results/loadgen_torch/`` of the checkout
(``RESULTS``).  This module is the other half of the trajectory: validate
those files, diff a fresh run against the latest baseline there, and print
the trajectory.  The reference's documents (``BENCH_6..10.json`` at the
repository root, CPU runs of the JAX package) are never read by default:
``--baseline`` takes any file.

Subcommands::

    python -m repro_torch.benchmarks.trajectory validate BENCH_1.json
    python -m repro_torch.benchmarks.trajectory compare BENCH_new.json \\
        [--baseline BENCH_1.json] [--threshold 0.5] [--strict]
    python -m repro_torch.benchmarks.trajectory show

``compare`` matches cells by identity tuple (``slots/depth/layout/
backend/chunk_frames/mesh``; a schema-v1 cell's backend defaults to
``jnp`` and a pre-v3 cell's chunk_frames to ``1``, so newer docs diff
cleanly against older baselines) and flags a regression
when a latency percentile rises — or saturation/throughput falls — by
more than ``--threshold`` (relative).  Latency is
machine-dependent: when the two files carry different machine
fingerprints or workload identities the comparison is *informational*
(printed, exit 0) unless ``--strict`` forces enforcement; same-machine
regressions exit non-zero.  A missing baseline is not an error — the
first trajectory point has nothing to diff against.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

# the load generator's documents, in the checkout (``.gitignore`` lists
# ``results/``)
RESULTS = Path(__file__).resolve().parents[3] / "results" / "loadgen_torch"

# v2 (BENCH_7+): cells carry a "backend" identity axis
# v3 (BENCH_9+): cells carry a "chunk_frames" identity axis and a traced
# "dispatches_per_frame" stat (frame-chunked dispatch amortization)
SCHEMA_VERSION = 3
SUPPORTED_SCHEMA_VERSIONS = (1, 2, 3)

BENCH_NAME = re.compile(r"^BENCH_(\d+)\.json$")

# metric -> direction: +1 means larger-is-worse (latency), -1 means
# smaller-is-worse (throughput/saturation).  Paths index into a cell dict.
COMPARED_METRICS = (
    (("frame_latency_us", "p50"), +1),
    (("frame_latency_us", "p99"), +1),
    (("saturation_streams_per_s",), -1),
    (("throughput_frames_per_s",), -1),
)

_REQUIRED_TOP = {
    "schema_version": int,
    "bench": str,
    "kind": str,
    "created_utc": str,
    "git_sha": str,
    "machine": dict,
    "model": dict,
    "workload": dict,
    "cells": list,
    "derived": dict,
}

_REQUIRED_CELL = {
    "key": str,
    "slots": int,
    "pipeline_depth": int,
    "layout": str,
    "mesh": int,
    "streams": int,
    "frames": int,
    "frame_latency_us": dict,
    "stream_completion_ms": dict,
    "queue_wait_ms": dict,
    "throughput_frames_per_s": (int, float),
    "saturation_streams_per_s": (int, float),
    "host_syncs_per_frame": (int, float),
    "sparsity": dict,
}

_REQUIRED_STATS = ("n", "p50", "p95", "p99", "mean", "max")


def validate_doc(doc) -> list[str]:
    """Schema check of one BENCH document; returns human-readable errors
    (empty list = valid).  Shared by the writer (``loadgen`` refuses to
    emit an invalid file) and the CI smoke (``trajectory validate``)."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    for key, typ in _REQUIRED_TOP.items():
        if key not in doc:
            errors.append(f"missing top-level key {key!r}")
        elif not isinstance(doc[key], typ):
            errors.append(f"{key!r} must be {typ}, got {type(doc[key])}")
    if errors:
        return errors
    if doc["schema_version"] not in SUPPORTED_SCHEMA_VERSIONS:
        errors.append(f"schema_version {doc['schema_version']} not in "
                      f"supported {SUPPORTED_SCHEMA_VERSIONS}")
    if not doc["cells"]:
        errors.append("cells is empty")
    required_cell = dict(_REQUIRED_CELL)
    if doc["schema_version"] >= 2:
        required_cell["backend"] = str  # the v2 identity axis
    if doc["schema_version"] >= 3:
        required_cell["chunk_frames"] = int  # the v3 identity axis
        required_cell["dispatches_per_frame"] = (int, float)
    seen = set()
    for i, cell in enumerate(doc["cells"]):
        where = f"cells[{i}]"
        if not isinstance(cell, dict):
            errors.append(f"{where} is not an object")
            continue
        for key, typ in required_cell.items():
            if key not in cell:
                errors.append(f"{where} missing {key!r}")
            elif not isinstance(cell[key], typ):
                errors.append(f"{where}.{key} must be {typ}, "
                              f"got {type(cell[key])}")
        for stats_key in ("frame_latency_us", "stream_completion_ms",
                          "queue_wait_ms"):
            stats = cell.get(stats_key)
            if isinstance(stats, dict):
                for f in _REQUIRED_STATS:
                    if f not in stats:
                        errors.append(f"{where}.{stats_key} missing {f!r}")
        key = cell.get("key")
        if key in seen:
            errors.append(f"{where} duplicate cell key {key!r}")
        seen.add(key)
    return errors


def load_doc(path: Path) -> dict:
    doc = json.loads(Path(path).read_text())
    errors = validate_doc(doc)
    if errors:
        raise ValueError(f"{path}: invalid BENCH document: "
                         + "; ".join(errors))
    return doc


def bench_files(root: Path = RESULTS) -> list[Path]:
    """The trajectory points in ``root``, ascending by index (none when
    ``root`` does not exist)."""
    if not root.is_dir():
        return []
    found = []
    for p in root.iterdir():
        m = BENCH_NAME.match(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def latest_baseline(root: Path, exclude: Path | None = None) -> Path | None:
    """The highest-index BENCH_*.json other than ``exclude``."""
    files = [p for p in bench_files(root)
             if exclude is None or p.resolve() != Path(exclude).resolve()]
    return files[-1] if files else None


# ----------------------------------------------------------------- compare


def _get(cell: dict, path: tuple):
    v = cell
    for k in path:
        v = v[k]
    return float(v)


def _cell_identity(cell: dict) -> tuple:
    """The sweep coordinates a cell is matched on across schema versions.

    A v1 cell predates the backend axis; it was always served by the
    ``jnp`` backend, so it defaults there — a v2 run's jnp cells line up
    against the v1 baseline and the other backends show up as new cells.
    Likewise a pre-v3 cell predates frame chunking and was always served
    one frame per dispatch, so chunk_frames defaults to 1 — a v3 run's
    unchunked cells line up against v1/v2 baselines and the chunked cells
    show up as new.
    """
    return (cell["slots"], cell["pipeline_depth"], cell["layout"],
            cell.get("backend", "jnp"), cell.get("chunk_frames", 1),
            cell["mesh"])


def _model_identity(doc: dict) -> dict:
    """Model identity for comparability: v1 docs carried the backend in
    the model dict, v2 moved it into the cells — strip it so the axis
    move doesn't break enforcement against older baselines."""
    return {k: v for k, v in doc["model"].items() if k != "backend"}


def compare_docs(new: dict, base: dict, threshold: float) -> dict:
    """Cell-by-cell diff -> {comparable, regressions, improvements, lines}.

    ``comparable`` is False when machine fingerprints or workload/model
    identities differ (latency numbers then don't support a pass/fail
    verdict — the diff is reported but not enforced unless --strict).
    """
    fp_match = new["machine"] == base["machine"]
    wl_match = (new["workload"] == base["workload"]
                and _model_identity(new) == _model_identity(base))
    base_cells = {_cell_identity(c): c for c in base["cells"]}
    lines, regressions, improvements = [], [], []
    matched = 0
    for cell in new["cells"]:
        b = base_cells.get(_cell_identity(cell))
        if b is None:
            lines.append(f"  {cell['key']}: new cell (no baseline)")
            continue
        matched += 1
        for path, direction in COMPARED_METRICS:
            name = ".".join(path)
            old_v, new_v = _get(b, path), _get(cell, path)
            if old_v <= 0:
                continue
            rel = (new_v - old_v) / old_v * direction  # >0 = worse
            tag = ""
            if rel > threshold:
                tag = "  REGRESSION"
                regressions.append(f"{cell['key']}.{name}: "
                                   f"{old_v:g} -> {new_v:g} "
                                   f"({rel * direction:+.0%})")
            elif rel < -threshold:
                tag = "  improved"
                improvements.append(f"{cell['key']}.{name}")
            lines.append(f"  {cell['key']}.{name}: {old_v:g} -> {new_v:g}"
                         f" ({(new_v - old_v) / old_v:+.0%}){tag}")
    new_ids = {_cell_identity(c) for c in new["cells"]}
    for ident, b in sorted(base_cells.items(), key=lambda kv: kv[1]["key"]):
        if ident not in new_ids:
            lines.append(f"  {b['key']}: dropped from new run")
    return {"comparable": fp_match and wl_match,
            "fingerprint_match": fp_match,
            "workload_match": wl_match,
            "matched_cells": matched,
            "regressions": regressions,
            "improvements": improvements,
            "lines": lines}


def cmd_compare(args) -> int:
    new = load_doc(Path(args.new))
    base_path = (Path(args.baseline) if args.baseline
                 else latest_baseline(RESULTS, exclude=Path(args.new)))
    if base_path is None or not base_path.exists():
        print(f"[trajectory] no baseline in {RESULTS} to compare against; "
              f"{args.new} is the first trajectory point (ok)")
        return 0
    base = load_doc(base_path)
    result = compare_docs(new, base, args.threshold)
    print(f"[trajectory] {args.new} vs {base_path.name} "
          f"(threshold {args.threshold:.0%}, "
          f"{result['matched_cells']} matched cells)")
    for line in result["lines"]:
        print(line)
    if not result["fingerprint_match"]:
        print("[trajectory] machine fingerprints differ — comparison is "
              "informational" + (" (--strict enforces anyway)"
                                 if not args.strict else ""))
    if not result["workload_match"]:
        print("[trajectory] workload/model identities differ — comparison "
              "is informational")
    if result["regressions"]:
        print(f"[trajectory] {len(result['regressions'])} regression(s) "
              f"beyond the {args.threshold:.0%} noise threshold:")
        for r in result["regressions"]:
            print(f"  {r}")
        if result["comparable"] or args.strict:
            return 1
        print("[trajectory] not comparable (different machine/workload): "
              "exit 0")
    else:
        print("[trajectory] no regressions beyond threshold")
    return 0


def cmd_validate(args) -> int:
    errors = validate_doc(json.loads(Path(args.path).read_text()))
    for e in errors:
        print(f"ERROR {args.path}: {e}")
    print(f"{args.path}: {'FAIL' if errors else 'ok'} "
          f"({len(errors)} schema errors)")
    return 1 if errors else 0


def cmd_show(args) -> int:
    files = bench_files(RESULTS)
    if not files:
        print(f"no BENCH_*.json in {RESULTS} yet")
        return 0
    for p in files:
        try:
            doc = load_doc(p)
        except ValueError as e:
            print(f"{p.name}: INVALID ({e})")
            continue
        print(f"{p.name}  sha={doc['git_sha'][:10]}  {doc['created_utc']}  "
              f"{doc['machine'].get('platform', '?')}")
        for c in doc["cells"]:
            print(f"  {c['key']:<32} frame p50/p99 = "
                  f"{c['frame_latency_us']['p50']:>8g}/"
                  f"{c['frame_latency_us']['p99']:>8g} us   "
                  f"sat = {c['saturation_streams_per_s']:g} streams/s")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("compare", help="diff a fresh BENCH file against "
                                       "the latest baseline")
    p.add_argument("new", help="freshly generated BENCH_*.json")
    p.add_argument("--baseline", default=None,
                   help="explicit baseline (default: the highest-index "
                        "BENCH_*.json in results/loadgen_torch)")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="relative noise threshold (default 0.5 = 50%%)")
    p.add_argument("--strict", action="store_true",
                   help="enforce regressions even across machine/workload "
                        "mismatches")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("validate", help="schema-check one BENCH file")
    p.add_argument("path")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("show", help="print the trajectory in "
                                    "results/loadgen_torch")
    p.set_defaults(fn=cmd_show)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
