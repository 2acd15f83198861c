"""The dry-run and roofline tables from the port's dry-run records
(results/dryrun_torch, written by ``launch/dryrun.py``).

The reference's ``benchmarks/report.py`` over the port's records: the
trace's seconds stand where the reference prints compile seconds, and
the collective column shows "—" (the port counts no collectives).

  PYTHONPATH=src python -m repro_torch.benchmarks.report
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.benchmarks import roofline

BASE = Path(__file__).resolve().parents[3] / "results"


def dryrun_table(mesh: str) -> str:
    rows = []
    for f in sorted((BASE / "dryrun_torch").glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        arch, shape = rec["arch"], rec["shape"]
        if rec.get("skipped"):
            rows.append(f"| {arch} | {shape} | SKIP | — | — | — | — |")
            continue
        if not rec.get("ok"):
            rows.append(f"| {arch} | {shape} | FAIL | — | — | — | — |")
            continue
        ma = rec.get("memory_analysis", {})
        args_gb = ma.get("argument_size_in_bytes", 0) / 1e9
        t = rec["tripaware"]
        coll = "—" if t["collective_total"] is None else \
            f"{t['collective_total'] / 1e9:.1f}"
        rows.append(
            f"| {arch} | {shape} | ok | {rec.get('lower_s', '—')} | "
            f"{args_gb:.2f} | {t['flops']:.2e} | {coll} |")
    header = ("| arch | shape | status | trace s | state GB/dev | "
              "FLOPs/dev | collective GB/dev |\n|---|---|---|---|---|---|---|")
    return header + "\n" + "\n".join(rows)


def main():
    print("## Dry-run single-pod (16x16 = 256 devices)\n")
    print(dryrun_table("pod"))
    print("\n## Dry-run multi-pod (2x16x16 = 512 devices)\n")
    print(dryrun_table("multipod"))
    print("\n## Roofline (single-pod, one H100 a device)\n")
    roofline.RESULTS = BASE / "dryrun_torch"
    print(roofline.markdown(roofline.table("pod")))


if __name__ == "__main__":
    main()
