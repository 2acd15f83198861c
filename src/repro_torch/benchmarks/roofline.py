"""Roofline analysis over the dry-run records (``launch/dryrun.py``).

Per (arch x shape x mesh) cell, from results/dryrun_torch/*.json:
  compute term    = FLOPs / (chips * 989 TFLOP/s)
  memory term     = bytes / (chips * 3.35 TB/s)
  collective term = collective_bytes / (chips * 450 GB/s)
(tripaware numbers are per-device; global = x chips, so the per-chip time is
the per-device quantity over the per-chip rate.)

Also: dominant term, MODEL_FLOPS / FLOPs (useful-compute fraction),
roofline fraction = ideal compute time / dominant term, and an action note.

The reference's ``benchmarks/roofline.py``, rated at one NVIDIA H100 SXM
(80 GB HBM3, 700 W): the datasheet's dense bf16 tensor-core peak, HBM3
rate and NVLink 4 rate in one direction.  The port's records count no
collectives (``collective_total`` null): the collective term is then
shown as "—" and the dominant term is taken over compute and memory.
The port's bytes are the eager program's, unfused.  Reads records only;
times nothing.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [pod|multipod]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.analysis.model_flops import model_flops
from repro_torch.configs.base import shape_by_name

# one NVIDIA H100 SXM 80GB HBM3 at its 700 W limit (datasheet rates)
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # B/s
LINK_BW = 450e9  # B/s, NVLink 4, one direction

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

_ACTIONS = {
    "compute": "cut redundant compute: remat policy / dispatch einsum / head-sharding so per-chip FLOPs approach MODEL_FLOPS/chips",
    "memory": "cut HBM traffic: int4/bf16 weights, fuse elementwise chains, larger effective batch per weight fetch (the paper's weight-reuse insight)",
    "collective": "cut bytes on the wire: reduce-scatter instead of all-gather, overlap collectives with compute, int8 gradient compression",
}


def load_cells(mesh: str = "pod") -> list[dict]:
    return [json.loads(f.read_text())
            for f in sorted(RESULTS.glob(f"*__{mesh}.json"))]


def roofline_row(rec: dict) -> dict | None:
    if rec.get("skipped"):
        return {"arch": rec["arch"], "shape": rec["shape"], "skipped": True,
                "reason": rec.get("reason", "")}
    if not rec.get("ok"):
        return {"arch": rec["arch"], "shape": rec["shape"],
                "error": rec.get("error")}
    t = rec["tripaware"]
    chips = rec["num_devices"]
    compute_s = t["flops"] / PEAK_FLOPS
    memory_s = t["hbm_bytes"] / HBM_BW
    coll = t["collective_total"]
    coll_s = None if coll is None else coll / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s}
    if coll_s is not None:
        terms["collective"] = coll_s
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec["arch"], shape_by_name(rec["shape"]))
    useful = mf / (t["flops"] * chips) if t["flops"] else 0.0
    ideal_s = mf / chips / PEAK_FLOPS
    frac = ideal_s / max(terms.values()) if max(terms.values()) else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "dominant": dominant, "model_flops": mf,
        "useful_fraction": useful, "roofline_fraction": frac,
        "action": _ACTIONS[dominant],
    }


def table(mesh: str = "pod") -> list[dict]:
    return [r for r in (roofline_row(rec) for rec in load_cells(mesh)) if r]


def markdown(rows: list[dict]) -> str:
    out = ["| arch | shape | compute s | memory s | collective s | dominant | MODEL/FLOPs | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — | — |")
            continue
        if r.get("error"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | — | — |")
            continue
        coll = "—" if r["collective_s"] is None else f"{r['collective_s']:.3e}"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {coll} | {r['dominant']} | "
            f"{r['useful_fraction']:.3f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(out)


def main():
    mesh = sys.argv[1] if len(sys.argv) > 1 else "pod"
    rows = table(mesh)
    print(markdown(rows))
    ok = [r for r in rows if "roofline_fraction" in r]
    if ok:
        worst = sorted(ok, key=lambda r: r["roofline_fraction"])[:5]
        print("\nworst roofline fractions:")
        for r in worst:
            print(f"  {r['arch']} {r['shape']}: {r['roofline_fraction']:.4f} "
                  f"(dominant={r['dominant']}) -> {r['action']}")
        coll = sorted((r for r in ok if r["collective_s"] is not None),
                      key=lambda r: -r["collective_s"])[:3]
        print("most collective-bound:" + ("" if coll else
                                          " — (no collectives counted)"))
        for r in coll:
            print(f"  {r['arch']} {r['shape']}: coll={r['collective_s']:.3e}s")


if __name__ == "__main__":
    main()
