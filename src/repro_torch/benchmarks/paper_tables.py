"""One function per paper table/figure, as ``benchmarks/paper_tables.py``
has them.  Each returns (rows, derived) where rows are CSV-able dicts,
built from ``core/complexity.py``'s accelerator model.  Error-rate figures
(14/16) and the measured sparsity read the ``results.json`` that
``examples/train_rsnn_timit_torch.py`` (or the reference's example)
writes; without one the tables fall back to the paper's Fig. 18
operating point.

The results file is an argument of every table (``results``: a path, the
loaded payload, or None for ``runs/rsnn_pipeline/results.json``); a path
that does not exist counts as no results.  ``bench_rsnn_forward`` times
the float golden model and ``bench_stream_sharded`` the sharded slot loop
on ``device`` (``cuda`` unless the caller asks for ``cpu``; no GPU
raises).

  python -m repro_torch.benchmarks.paper_tables [--results PATH] \\
      [--device cuda|cpu]

prints one ``name,us_per_call,derived`` CSV line a table, as
``benchmarks/run.py`` does (analytic tables report 0 us).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.rsnn_timit import BASELINE as BASE
from repro_torch.configs.rsnn_timit import PRUNED
from repro_torch.core import complexity as C
from repro_torch.core import rsnn
from repro_torch.serving.stream import resolve_device

RESULTS = Path(__file__).resolve().parents[3] / "runs" / "rsnn_pipeline" / "results.json"

Results = str | Path | list[dict] | None


def _pipeline_results(results: Results = None) -> list[dict] | None:
    if isinstance(results, list):
        return results
    path = RESULTS if results is None else Path(results)
    if path.exists():
        return json.loads(path.read_text())
    return None


def table1_dimensions(results: Results = None):
    rows = []
    for name, cfg, frac in [("baseline", BASE, 0.0),
                            ("structured", PRUNED, 0.0),
                            ("unstructured", PRUNED, 0.4)]:
        rows.append({"model": name, **{k: str(v) for k, v in cfg.layer_shapes.items()},
                     "parameters": C.num_params(cfg, frac)})
    return rows, {"paper": "698368 / 300032 / 201728"}


def fig12_model_size(results: Results = None):
    steps = [("baseline fp32", BASE, 32, 0.0),
             ("+structured", PRUNED, 32, 0.0),
             ("+unstructured", PRUNED, 32, 0.4),
             ("+4bit QAT", PRUNED, 4, 0.4)]
    rows = [{"stage": n, "MB": round(C.model_size_bytes(c, b, f) / 1e6, 3)}
            for n, c, b, f in steps]
    red = 1 - C.model_size_bytes(PRUNED, 4, 0.4) / C.model_size_bytes(BASE, 32)
    return rows, {"total_reduction": f"{red:.2%}", "paper": "96.42%"}


def fig13_complexity(results: Results = None):
    sp = _measured_sparsity(results) or C.SparsityProfile()
    rows = [
        {"variant": "baseline 2ts", "mmac_s": C.mmac_per_second(BASE, 2)},
        {"variant": "+structured 2ts", "mmac_s": C.mmac_per_second(PRUNED, 2)},
        {"variant": "+zero-skip 2ts", "mmac_s": C.mmac_per_second(PRUNED, 2, sparsity=sp)},
        {"variant": "+merged-spike 2ts",
         "mmac_s": C.mmac_per_second(PRUNED, 2, sparsity=sp, merged_spike=True)},
        {"variant": "structured 1ts", "mmac_s": C.mmac_per_second(PRUNED, 1)},
        {"variant": "+zero-skip 1ts", "mmac_s": C.mmac_per_second(PRUNED, 1, sparsity=sp)},
    ]
    base = rows[0]["mmac_s"]
    return rows, {"reduction_2ts": f"{1 - rows[3]['mmac_s'] / base:.2%} (paper 89.02%)",
                  "reduction_1ts": f"{1 - rows[5]['mmac_s'] / base:.2%} (paper 90.49%)"}


def fig14_error_ablation(results: Results = None):
    res = _pipeline_results(results)
    if not res:
        return [], {"note": "run examples/train_rsnn_timit.py to populate"}
    rows = [{"stage": r["name"], "frame_error_rate": round(r["error_rate"], 4),
             "size_KB": round(r["size_bytes"] / 1e3, 1)} for r in res]
    return rows, {"paper_trend": "22.2% -> 22.6% (relative degradation ~0.4pt)"}


def fig16_time_steps(results: Results = None):
    res = _pipeline_results(results)
    rows = []
    if res and "ts_sweep" in (res[-1] if isinstance(res, list) else {}):
        rows = res[-1]["ts_sweep"]
    return rows, {"note": "error improves mildly with ts (paper Fig. 16)"}


def fig17_cycles(results: Results = None):
    sp = _measured_sparsity(results) or C.SparsityProfile()
    rows = []
    for ts in (1, 2):
        rows.append({"config": f"{ts}ts dense", "cycles": C.cycles_per_frame(PRUNED, ts)})
        rows.append({"config": f"{ts}ts zero-skip",
                     "cycles": round(C.cycles_per_frame(PRUNED, ts, sparsity=sp), 1)})
    rows.append({"config": "2ts skip+merged",
                 "cycles": round(C.cycles_per_frame(PRUNED, 2, sparsity=sp,
                                                    merged_spike=True), 1)})
    f = C.realtime_frequency_hz(rows[-1]["cycles"])
    return rows, {"min_realtime_clock_kHz": round(f / 1e3, 1),
                  "paper": "2464/1312 -> 1224/574 -> 895 @ 100 kHz"}


def fig18_sparsity(results: Results = None):
    sp = _measured_sparsity(results)
    src = "measured" if sp else "paper defaults"
    sp = sp or C.SparsityProfile()
    rows = [{"signal": "input bits", "sparsity": round(1 - sp.input_bit_density, 3)}]
    for ts in range(2):
        rows.append({"signal": f"L0 T{ts}", "sparsity": round(1 - sp.l0_density[ts], 3)})
        rows.append({"signal": f"L1 T{ts}", "sparsity": round(1 - sp.l1_density[ts], 3)})
    rows.append({"signal": "L1 union (merged)", "sparsity": round(1 - sp.fc_union_density, 3)})
    return rows, {"source": src, "paper": "57-71%"}


def table2_weight_access(results: Results = None):
    rows = [
        {"dataflow": "layer-based", "accesses_per_frame":
            C.weight_accesses_per_frame(BASE, 2, parallel_time_steps=False)},
        {"dataflow": "parallel time steps", "accesses_per_frame":
            C.weight_accesses_per_frame(BASE, 2, parallel_time_steps=True)},
    ]
    return rows, {"saving": "47% fewer weight-buffer reads (paper: ~50%)"}


def table3_power(results: Results = None):
    """Table III / Figs 19-20: power, energy/frame, efficiency proxies."""
    sp = _measured_sparsity(results) or C.SparsityProfile()
    cyc = C.cycles_per_frame(PRUNED, 2, sparsity=sp, merged_spike=True)
    rows = [
        {"point": "always-on 100 kHz", "power_uW": round(C.power_w(100e3) * 1e6, 1),
         "energy_per_frame_nJ": round(C.energy_per_frame_j(cyc, 100e3) * 1e9, 1)},
        {"point": "peak 500 MHz", "power_mW": round(C.power_w(500e6) * 1e3, 1),
         "energy_per_frame_nJ": round(C.energy_per_frame_j(cyc, 500e6) * 1e9, 1)},
        {"point": "efficiency", "dense_equiv_TOPS_per_W":
            round(C.tops_per_watt(PRUNED, 2, sparsity=sp), 2)},
    ]
    return rows, {"paper": "71.2 uW / 35.5 mW / 63.5 nJ/frame / 28.41 TOPS/W"}


def _measured_sparsity(results: Results = None) -> C.SparsityProfile | None:
    """The last stage's measured profile (``delta_input_density``, which a
    payload may carry, keeps its default: the tables model no delta
    gating)."""
    res = _pipeline_results(results)
    if not res:
        return None
    last = res[-1]
    if "sparsity" not in last:
        return None
    s = last["sparsity"]
    return C.SparsityProfile(
        input_bit_density=s["input_bit_density"],
        l0_density=tuple(s["l0_density"]), l1_density=tuple(s["l1_density"]),
        fc_density=tuple(s["fc_density"]),
        fc_union_density=s["fc_union_density"])


ANALYTIC = (table1_dimensions, fig12_model_size, fig13_complexity,
            fig14_error_ablation, fig16_time_steps, fig17_cycles,
            fig18_sparsity, table2_weight_access, table3_power)


# ----------------------------------------------------------- timing


@torch.no_grad()
def bench_rsnn_forward(device: torch.device | str = "cuda", iters: int = 20):
    """``core.rsnn.forward`` at ``PRUNED`` on (8, 100, 40) seeded inputs:
    microseconds a call, after one warm-up call (CUDA events on the card,
    the wall clock on the CPU)."""
    device = resolve_device(device)
    cfg = PRUNED
    params = rsnn.init_params(torch.Generator(device).manual_seed(0), cfg)
    x = torch.randn((8, 100, cfg.input_dim), device=device,
                    generator=torch.Generator(device).manual_seed(1))

    def fwd():
        return rsnn.forward(params, x, cfg)[0]

    fwd()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fwd()
        end.record()
        end.synchronize()
        us = start.elapsed_time(end) / iters * 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fwd()
        us = (time.perf_counter() - t0) / iters * 1e6
    frames = 8 * 100
    return us, {"us_per_frame": round(us / frames, 2),
                "realtime_streams": int(frames / (us / 1e6) / C.FRAMES_PER_SECOND)}


def bench_stream_sharded(device: torch.device | str = "cuda"):
    """``ShardedStreamLoop`` over every visible device of ``device``'s
    type (one entry for ``cpu``) serving 8 seeded utterances of 40-100
    frames with the reference's model (``PRUNED`` from seed 0, the FC
    pruned 40%, int4, input scale 0.05, the default backend): microseconds
    a step, frames/s and the measured sparsity of the served traffic,
    after one warm-up utterance.  The wall clock, synchronized on the
    card."""
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.serving.sharded import ShardedStreamLoop, stream_mesh
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    device = resolve_device(device)
    devices = stream_mesh(None if device.type == "cuda" else [device])
    cfg = PRUNED
    # drawn on the CPU: the same model on every device
    params = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    engine = CompiledRSNN(cfg, params,
                          EngineConfig(precision="int4", input_scale=0.05),
                          CompressionConfig(fc_prune_frac=0.4, weight_bits=4),
                          device=devices[0])
    rng = np.random.default_rng(0)
    utts = [0.5 * rng.normal(size=(int(rng.integers(40, 101)),
                                   cfg.input_dim)).astype(np.float32)
            for _ in range(8)]
    # the smallest multiple of the device count that covers 4 slots
    ndev = len(devices)
    loop = ShardedStreamLoop(engine, batch_slots=max(4 // ndev, 1) * ndev,
                             devices=devices, max_frames=128)
    loop.submit(utts[0][:4])  # warm-up, untimed
    loop.run()
    loop.finished.clear()
    loop.reset_metrics()
    for u in utts:
        loop.submit(u)

    def sync():
        if device.type == "cuda":
            for d in dict.fromkeys(devices):
                torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    loop.run()
    sync()
    dt = time.perf_counter() - t0
    frames = int(loop.counters.frames)
    prof = loop.sparsity_profile()
    return dt / max(loop.steps, 1) * 1e6, {
        "devices": ndev,
        "slots": loop.slots,
        "frames": frames,
        "frames_per_s": round(frames / dt, 1),
        "measured_mmac_per_s": round(loop.mmac_per_second(), 3),
        "sparsity_profile": {
            "input_bit_density": round(prof.input_bit_density, 4),
            "l0_density": [round(d, 4) for d in prof.l0_density],
            "l1_density": [round(d, 4) for d in prof.l1_density],
            "fc_union_density": round(prof.fc_union_density, 4),
        },
    }


def _emit(name: str, us: float, derived) -> None:
    print(f"{name},{us:.2f},{json.dumps(derived, default=str)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Print the paper's tables, bench_rsnn_forward and "
                    "bench_stream_sharded as CSV")
    ap.add_argument("--results", default=None, metavar="PATH",
                    help=f"the recipe's results.json (default: {RESULTS})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    results = _pipeline_results(args.results)

    print("name,us_per_call,derived")
    for table in ANALYTIC:
        rows, derived = table(results)
        _emit(table.__name__, 0.0, {"rows": rows, **derived})
    for bench in (bench_rsnn_forward, bench_stream_sharded):
        us, derived = bench(device)
        _emit(bench.__name__, us, derived)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
