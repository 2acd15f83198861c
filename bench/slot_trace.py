"""The slot loop's program spans against the card: one traced run of a
cell, or the spans' cost on a tiny loop on the CPU.

    python3 bench/slot_trace.py trace --seed <n> [--workload <name>] \\
        [--out <file>]
    python3 bench/slot_trace.py offcost [--dispatches <n>] [--rounds <n>]

from the root of a checkout.  ``trace`` makes one ``--trace 1`` run of
the cell (``harness.run``, on the card) and prints its result line, then
one JSON object with what the window's spans (``spanread.py``) and device
operations say together:

- ``self_ms``, ``total_ms`` and ``count``: each span name's self time,
  length and number a dispatch; ``root_covered``, the share of the root
  ``loop.step`` its children cover; ``root_ms`` against ``step_ms``, the
  harness's ``step_once`` timer (``loop_host_ms_per_dispatch.backlog``).
- ``clock``: the lag from each ``loop.dispatch`` span's start to the
  nearest host-to-device copy (the step's uploads, which that span
  queues on an idle card), least and median, over the window and in
  each third of it.  A copy cannot start before its span, so a negative
  least lag is the device clock's offset from ``time.time_ns``; the
  least lag is the shift (``shift_us``) that the named gaps below take
  off the device's stamps, so that no copy starts before its span.
- ``launches``: each K6 launch (``megastep_kernel``) against the
  dispatch span of the same number: the share that start after a
  dispatch span's start within ``pipeline_depth`` dispatches of their
  own, and the lag from their own span's start, raw and shifted.
- ``idle_top``: the ten longest idle gaps on the card, named by the
  innermost program span (``spanread.name_intervals``), on shifted
  stamps; ``idle_over_1ms_ms``: every gap over 1 ms, summed by name, on
  shifted stamps and on raw ones.

A program without spans prints its result line and ``{"spans": false}``.
``offcost`` times ``step_once`` of a small int4 loop on the CPU (8 slots,
chunks of 4 frames), recording off and, where the program has spans, on,
in turns, and one span off and on and the root's gate off, each in ns;
it prints one JSON object.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up of a traced run runs from here

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "rsnn-pruned-int4.dictation-backlog"
K6 = "megastep_kernel"
H2D = "Memcpy HtoD"
REACH_NS = 5_000_000  # a dispatch's upload lies within this of its span
MS = 1e6


def idle_gaps(busy: list[tuple[int, int]], t0: int, t1: int
              ) -> list[tuple[int, int]]:
    """The intervals of ``[t0, t1]`` outside the sorted, disjoint busy
    intervals ``busy``."""
    edges = [t0] + [t for iv in busy for t in iv] + [t1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def copy_lags(dispatch: list[int], copies: list[int]) -> list[int]:
    """For each dispatch span's start (sorted), the signed lag (ns) to the
    nearest copy start within ``REACH_NS``; spans with none are left
    out."""
    copies = sorted(copies)
    lags = []
    for d in dispatch:
        j = bisect.bisect_left(copies, d - REACH_NS)
        near = [c for c in copies[j:j + 16] if abs(c - d) <= REACH_NS]
        if near:
            lags.append(min(near, key=lambda c: abs(c - d)) - d)
    return lags


def launch_check(launches: list[int], dispatch: list[int], depth: int
                 ) -> tuple[float | None, list[int]]:
    """The share of launches (sorted starts, the k-th that of dispatch
    span k, sorted by start) that start after their own span's start and
    within ``depth`` dispatches of it (no more than ``depth`` later spans
    started before them), and each launch's lag (ns) from its own span's
    start."""
    ok, lags = 0, []
    for i, t in enumerate(launches[:len(dispatch)]):
        last = bisect.bisect_right(dispatch, t) - 1  # started before t
        ok += dispatch[i] <= t and last - i <= depth
        lags.append(t - dispatch[i])
    return (ok / len(launches) if launches else None), lags


def _quantiles(xs: list, scale: float) -> dict | None:
    if not xs:
        return None
    xs = sorted(xs)
    return {"least": xs[0] / scale, "median": statistics.median(xs) / scale,
            "p99": xs[min(len(xs) - 1, int(0.99 * len(xs)))] / scale,
            "most": xs[-1] / scale, "n": len(xs)}


def analyse(recs: list, ops: list[tuple[str, int, int]], t0: int, t1: int,
            dispatches: int, step_s: float, depth: int) -> dict:
    """The summary of one traced window: the program's records ``recs``
    inside ``[t0, t1]``, the device operations ``ops`` (name, start,
    end), the loop's dispatches and the harness's ``step_once`` seconds
    over the window (the module docstring's fields)."""
    from bench import spanread
    from bench.devtrace import DeviceTrace

    names = sorted({r.name for r in recs})
    own = spanread.self_ns(recs)
    root_ns = spanread.total_ns(recs, "loop.step")
    out = {
        "dispatches": dispatches,
        "self_ms": {n: own[n] / MS / dispatches for n in names},
        "total_ms": {n: spanread.total_ns(recs, n) / MS / dispatches
                     for n in names},
        "count": {n: sum(r.name == n for r in recs) / dispatches
                  for n in names},
        "root_covered": 1 - own.get("loop.step", 0) / root_ns
        if root_ns else None,
        "root_ms": root_ns / MS / dispatches,
        "step_ms": 1e3 * step_s / dispatches,
    }
    roots = sorted((r for r in recs if r.name == "loop.step"),
                   key=lambda r: r.end_ns)
    out["counts_first_last"] = [roots[0].counts, roots[-1].counts]

    # the clock: the uploads against their dispatch spans
    disp = sorted(r.start_ns for r in recs if r.name == "loop.dispatch")
    copies = [s for n, s, _ in ops if n.startswith(H2D)]
    lags = copy_lags(disp, copies)
    third = max(1, len(lags) // 3)
    out["clock"] = {
        "copy_lag_us": _quantiles(lags, 1e3),
        "least_by_third_us": [min(lags[k:k + third]) / 1e3
                              for k in range(0, len(lags), third)][:3],
    }
    shift = min(lags) if lags else 0
    out["clock"]["shift_us"] = shift / 1e3

    # K6 launches against the dispatch spans, raw and shifted
    k6 = sorted(s for n, s, _ in ops if K6 in n and t0 <= s <= t1)
    launches = {}
    for key, d in (("raw", 0), ("shifted", shift)):
        share, k6_lags = launch_check([s - d for s in k6], disp, depth)
        launches[key] = {"matched_share": share,
                         "lag_ms": _quantiles(k6_lags, MS)}
    launches["n"], launches["dispatch_spans"] = len(k6), len(disp)
    out["launches"] = launches

    # the idle gaps, named on shifted stamps and on raw ones
    def gaps(d: int) -> list[tuple[int, int]]:
        dev = DeviceTrace()
        dev.t0, dev.t1 = t0, t1
        dev.ops = [(n, s - d, e - d) for n, s, e in ops]
        return idle_gaps(dev.busy_intervals(), t0, t1)

    def over_1ms(d: int) -> dict[str, float]:
        big = [g for g in gaps(d) if g[1] - g[0] > MS]
        by: dict[str, float] = {}
        for lab, (s, e) in zip(spanread.name_intervals(recs, big), big):
            by[lab] = by.get(lab, 0.0) + (e - s) / MS
        return by

    top = sorted(gaps(shift), key=lambda g: g[0] - g[1])[:10]
    out["idle_top"] = [[lab, (e - s) / MS] for lab, (s, e) in
                       zip(spanread.name_intervals(recs, top), top)]
    out["idle_over_1ms_ms"] = {"shifted": over_1ms(shift),
                               "raw": over_1ms(0)}
    return out


def trace(args) -> int:
    from bench import harness
    from bench.families import rsnn

    # keep the window's device trace and counters, which the result line
    # leaves out
    seen = {}
    serve = rsnn.serve

    def keep(setup, window, *a, **k):
        got = serve(setup, window, *a, **k)
        seen.update(got=got, dt=window.trace,
                    depth=setup.program.pipeline_depth)
        return got

    rsnn.serve = keep
    try:
        result = harness.run(args.workload, args.seed, 10.0, True, T_START)
    except harness.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    finally:
        rsnn.serve = serve
    print(json.dumps(result))
    summary = {"workload": args.workload, "seed": args.seed,
               "result": result, "spans": False}
    try:
        from repro_torch.serving import spans
    except ImportError:  # a program without spans
        spans = None
    if spans is not None:
        got, dt = seen["got"], seen["dt"]
        recs = spans.window(dt.t0, dt.t1)
        summary["spans"] = True
        summary["dropped"] = spans.dropped()
        if recs:
            summary.update(analyse(
                recs, dt.ops, dt.t0, dt.t1,
                got.close["dispatches"] - got.open["dispatches"],
                got.close["step_s"] - got.open["step_s"], seen["depth"]))
    line = json.dumps({k: v for k, v in summary.items() if k != "result"})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


def offcost(args) -> int:
    import numpy as np
    import torch

    from repro_torch.core import rsnn
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.rsnn import RSNNConfig
    from repro_torch.serving.stream import (CompiledRSNN, EngineConfig,
                                            StreamLoop)
    try:
        from repro_torch.serving import spans
    except ImportError:  # a program without spans
        spans = None

    torch.set_num_threads(1)
    cfg = RSNNConfig(input_dim=8, hidden_dim=16, fc_dim=12, num_ts=2)
    params = rsnn.init_params(torch.Generator().manual_seed(0), cfg)
    engine = CompiledRSNN(
        cfg, params, EngineConfig(backend="fused", precision="int4",
                                  sparse_fc=True, input_scale=0.05),
        CompressionConfig(fc_prune_frac=0.4, weight_bits=4), device="cpu")
    loop = StreamLoop(engine, batch_slots=8, pipeline_depth=2,
                      chunk_frames=4, ring_frames=16)
    rng = np.random.default_rng(0)
    pool = [rng.normal(size=(n, 8)).astype(np.float32)
            for n in rng.integers(5, 40, 64)]
    k = 0

    def steps(n: int) -> float:
        nonlocal k
        d0, t = loop.dispatches, time.perf_counter()
        for _ in range(n):
            while len(loop.queue) < 8:
                loop.submit(pool[k % len(pool)])
                k += 1
            loop.step_once()
            loop.finished.clear()
        return 1e3 * (time.perf_counter() - t) / (loop.dispatches - d0)

    steps(200)  # warm
    off, on = [], []
    for _ in range(args.rounds):
        off.append(steps(args.dispatches))
        if spans is not None:
            with spans.recording():
                on.append(steps(args.dispatches))
            spans.clear()
    out = {"step_ms_off": statistics.median(off), "off": off,
           "spans": spans is not None}
    if spans is not None:
        out["step_ms_on"] = statistics.median(on)
        out["on"] = on
        n = 200_000
        for key, flag in (("span_ns_off", False), ("span_ns_on", True)):
            spans.on = flag
            t = time.perf_counter_ns()
            for _ in range(n):
                spans.end("loop.plan", spans.now())
            out[key] = (time.perf_counter_ns() - t) / n
        spans.on = False
        spans.clear()
        t = time.perf_counter_ns()
        for _ in range(n):
            spans.open_step(0)
        out["root_gate_ns_off"] = (time.perf_counter_ns() - t) / n
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--seed", type=int, required=True)
    t.add_argument("--workload", default=WORKLOAD)
    t.add_argument("--out")
    o = sub.add_parser("offcost")
    o.add_argument("--dispatches", type=int, default=500)
    o.add_argument("--rounds", type=int, default=9)
    args = p.parse_args(argv)
    return trace(args) if args.what == "trace" else offcost(args)


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.exit(main())
