"""One function per paper table/figure and timed row, as
``benchmarks/paper_tables.py`` has them.  The analytic tables return (rows,
derived) where rows are CSV-able dicts, built from ``core/complexity.py``'s
accelerator model.  Error-rate figures (14/16) and the measured sparsity
read the ``results.json`` that ``examples/train_rsnn_timit_torch.py`` (or
the reference's example) writes; without one the tables fall back to the
paper's Fig. 18 operating point.  The results file is an argument of every
table (``results``: a path, the loaded payload, or None for
``runs/rsnn_pipeline/results.json``); a path that does not exist counts as
no results.

The timed rows return (microseconds, derived) and run on ``device``
(``cuda`` unless the caller asks for ``cpu``; no GPU raises), each through
``kernels/ops.py``: a CUDA kernel on the card, its plain version on the
CPU.  They reach K3 (``bench_kernels``), K4 (``bench_sparse_fc``,
``bench_stream_engine``), K4 and K5 (``bench_nm_fc``), K1, K2, K4 and K6
(``bench_megastep``), K8 and K10 (``bench_delta``), K4, K6, K7, K9 and K10
(``bench_spike_broadcast``); ``bench_rsnn_forward``,
``bench_stream_sharded``, ``bench_stream_pipeline`` and
``bench_artifact_roundtrip`` serve through plain PyTorch.  Weights and the
reference's ``jax.random`` inputs come from two draw hooks on the CPU
generator (``_seeded_params``, ``_seeded_normal``), so that the card and
the CPU run one model; the reference's numpy draws are kept as they are.
``run.py`` beside this module (``python -m repro_torch.benchmarks.run``)
runs them all.

  python -m repro_torch.benchmarks.paper_tables [--results PATH] \\
      [--device cuda|cpu]

prints one ``name,us_per_call,derived`` CSV line for each analytic table,
``bench_rsnn_forward`` and ``bench_stream_sharded``, as
``benchmarks/run.py`` does (analytic tables report 0 us).  The rows' keys
are the reference's, but for ``realtime_streams`` (the reference's
``realtime_streams_cpu``) and what the port adds: the version of a kernel
that ran, each kernel's launches a step (``bench_megastep``) and each
logit comparison's measured values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.rsnn_timit import BASELINE as BASE
from repro_torch.configs.rsnn_timit import PRUNED
from repro_torch.core import artifact as artifact_lib
from repro_torch.core import complexity as C
from repro_torch.core import layouts, rsnn
from repro_torch.core import sparse as sparse_lib
from repro_torch.core.compression import (CompressionConfig, PruneSpec,
                                          init_compression, pruning)
from repro_torch.core.compression.quantization import quantize_to_int
from repro_torch.core.rsnn import RSNNConfig
from repro_torch.core.tree import tree_map
from repro_torch.kernels import ops
from repro_torch.serving import backends
from repro_torch.serving.sharded import ShardedStreamLoop, stream_mesh
from repro_torch.serving.stream import (CompiledRSNN, EngineConfig,
                                        StreamLoop, resolve_device)

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


# ----------------------------------------------------------- draws


def _seeded_params(cfg: RSNNConfig, seed: int) -> dict:
    """A row's float parameters: ``rsnn.init_params`` on the CPU generator
    from ``seed``.  A CUDA generator draws other numbers, so every row
    draws here and moves the tree to its device: the card and the CPU run
    one model."""
    return rsnn.init_params(torch.Generator().manual_seed(seed), cfg)


def _seeded_normal(shape: tuple, seed: int) -> torch.Tensor:
    """Standard normal draws from ``seed`` on the CPU generator, where the
    reference draws ``jax.random.normal(PRNGKey(seed), shape)``."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _params(cfg: RSNNConfig, seed: int, device: torch.device) -> dict:
    return tree_map(lambda t: t.to(device), _seeded_params(cfg, seed))


# ----------------------------------------------------------- timing


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_us(fn, *args, iters: int = 20, device: torch.device | str
            ) -> float:
    """Microseconds a call of ``fn(*args)``, after one warm-up call.  On
    the card the warm-up is fenced with ``torch.cuda.synchronize`` and CUDA
    events span ``iters`` back-to-back calls (a call that waits on the
    host spans its wall time there); on the CPU, the wall clock."""
    device = torch.device(device)
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def _p50_us(step, device: torch.device, samples: int = 30) -> float:
    """The median of ``samples`` wall-clock times of ``step()``, each
    fenced by ``torch.cuda.synchronize`` on the card, after one fenced
    warm-up call."""
    step()
    _sync(device)
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        step()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return round(times[len(times) // 2], 2)


def _ran(kernel: str, device: torch.device) -> str:
    """Which version of ``kernel`` a row ran: the CUDA kernel on the card,
    the plain PyTorch version on the CPU."""
    if device.type == "cuda":
        return f"{kernel} (CUDA kernel, csrc/{kernel}.cu)"
    return f"{kernel} (plain PyTorch version on the CPU)"


def _against(logits: np.ndarray, base: np.ndarray) -> dict:
    """``logits`` against ``base``: bit-equal or not, the largest
    |difference| and the argmax agreement."""
    return {"bit_identical": bool(np.array_equal(logits, base)),
            "max_abs_logit_diff": float(np.abs(logits - base).max()),
            "argmax_agreement": round(float(np.mean(
                np.argmax(logits, axis=-1) == np.argmax(base, axis=-1))), 4)}


# ----------------------------------------------------------- timed rows
#
# Each row takes ``device`` (``cuda`` unless the caller asks for ``cpu``;
# no GPU raises) and returns (microseconds, derived), as the reference's
# rows do.  Kernel rows time with ``time_us``, step rows with ``_p50_us``,
# loop rows with the wall clock synchronized at both ends.  A row asserts
# each bit-equality the port holds on its device: on the CPU every
# comparison the reference asserts or reports (plain versions throughout);
# on the card K5 against K4 on one mask, the artifact against in-process
# packing and ``fused`` against ``fused_spike``, the other comparisons
# with the ``jnp`` (``ref``) backend reported as measured (K2 scales an
# integer sum once where ``ref`` sums dequantized weights, and the cells'
# sums run in another order).


@torch.no_grad()
def bench_rsnn_forward(device: torch.device | str = "cuda", iters: int = 20):
    """``core.rsnn.forward`` at ``PRUNED`` on (8, 100, 40) seeded inputs:
    microseconds a call (``time_us``)."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    x = _seeded_normal((8, 100, cfg.input_dim), 1).to(device)
    us = time_us(lambda: rsnn.forward(params, x, cfg)[0], iters=iters,
                 device=device)
    frames = 8 * 100
    return us, {"us_per_frame": round(us / frames, 2),
                "realtime_streams": int(frames / (us / 1e6)
                                        / C.FRAMES_PER_SECOND)}


@torch.no_grad()
def bench_stream_engine(device: torch.device | str = "cuda"):
    """The int4 ``PRUNED`` engine (FC pruned 40%, the ``jnp`` backend)
    over (8, 100, 40) seeded frames: microseconds a ``CompiledRSNN.run``
    of the 800 frames (``time_us``, 5 calls) and their L1 spike density.
    Then the same plain cells with the zero-skip readout two ways, 4 calls
    each, so that the difference isolates the FC: the materializing gather
    (``jnp`` with ``sparse_fc``, the CSC layout's plain oracle) and K4
    ``sparse_fc``, plugged in as the bench-local ``bench_ref_fused_fc``
    backend, which the row registers and unregisters."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    cstate = init_compression(params, ccfg)

    def build(**engine_kw):
        return CompiledRSNN(cfg, params,
                            EngineConfig(input_scale=0.05, **engine_kw),
                            ccfg, cstate, device=device)

    engine = build(precision="int4")
    x = _seeded_normal((8, 100, cfg.input_dim), 1).to(device)
    state = engine.init_state(8)
    us = time_us(lambda: engine.run(x, state)[0], iters=5, device=device)
    _, _, aux = engine.run(x, state)
    frames = 8 * 100
    spikes_l1 = float(aux["spikes_l1"].sum())

    def variant_us(**engine_kw) -> float:
        eng = build(**engine_kw)
        st = eng.init_state(8)
        return time_us(lambda: eng.run(x, st)[0], iters=4, device=device)

    try:
        @backends.register("bench_ref_fused_fc", dense_stimulus=True)
        def _ref_cells_fused_fc(ctx):
            table = backends.resolve(
                "ref", dataclasses.replace(ctx, sparse_fc=False))
            sc = ctx.sparse["fc_w"]
            return table._replace(
                name="bench_ref_fused_fc",
                fc=lambda s1: ops.sparse_fc(s1, sc.indices, sc.values,
                                            sc.scale))

        gather_us = variant_us(backend="jnp", precision="int4",
                               sparse_fc=True)
        fused_us = variant_us(backend="bench_ref_fused_fc",
                              precision="int4")
    finally:
        backends.unregister("bench_ref_fused_fc")  # bench-local plugin only
    return us, {
        "path": "int4 packed, jnp (plain PyTorch) backend",
        "fc_kernel": _ran("sparse_fc", device),
        "us_per_frame": round(us / frames, 2),
        "realtime_streams": int(frames / (us / 1e6) / C.FRAMES_PER_SECOND),
        "l1_spike_density": round(
            spikes_l1 / (frames * cfg.num_ts * cfg.hidden_dim), 4),
        "sparse_gather_us_per_frame": round(gather_us / frames, 2),
        "sparse_fused_us_per_frame": round(fused_us / frames, 2),
        "sparse_fused_speedup": round(gather_us / fused_us, 3),
    }


@torch.no_grad()
def bench_stream_pipeline(device: torch.device | str = "cuda"):
    """The v2 ``StreamLoop`` (``pipeline_depth=2``) against the v1 loop
    and against v2 at chunks of 8 frames, one slot (the paper's always-on
    single microphone, where a step is a frame), 6 seeded utterances of
    40-80 frames through the int4 ``PRUNED`` engine: microseconds a step
    and a frame, and host syncs and dispatches a frame.  Each loop serves a
    throwaway utterance first (on the card it has captured its step graph
    at construction); the wall clock, synchronized at both ends."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    engine = CompiledRSNN(cfg, params,
                          EngineConfig(precision="int4", input_scale=0.05),
                          ccfg, device=device)
    rng = np.random.default_rng(0)
    utts = [0.5 * rng.normal(size=(int(rng.integers(40, 81)),
                                   cfg.input_dim)).astype(np.float32)
            for _ in range(6)]

    def run_loop(depth, chunk=1):
        # the ring holds an utterance (<= 80 frames) and is a multiple of
        # every chunk used here; the watermark flush covers longer streams
        loop = StreamLoop(engine, batch_slots=1, pipeline_depth=depth,
                          ring_frames=96, chunk_frames=chunk)
        loop.submit(utts[0][:4])  # warm host-side paths outside the timing
        loop.run()
        loop.finished.clear()
        loop.reset_metrics()
        for u in utts:
            loop.submit(u)
        _sync(device)
        t0 = time.perf_counter()
        loop.run()
        _sync(device)
        dt = time.perf_counter() - t0
        frames = int(loop.counters.frames)
        return (dt / max(loop.steps, 1) * 1e6, loop.host_syncs, frames,
                loop.dispatches, dt)

    sync_us, sync_syncs, frames, _, _ = run_loop(0)
    pipe_us, pipe_syncs, frames2, pipe_disp, pipe_dt = run_loop(2)
    _, _, frames3, chunk_disp, chunk_dt = run_loop(2, chunk=8)
    assert frames == frames2 == frames3
    return pipe_us, {
        "workload": f"{len(utts)} streams / {frames} frames, 1 slot, int4",
        "sync_us_per_step": round(sync_us, 2),
        "pipelined_us_per_step": round(pipe_us, 2),
        "sync_host_syncs_per_frame": round(sync_syncs / frames, 3),
        "pipelined_host_syncs_per_frame": round(pipe_syncs / frames, 3),
        "host_syncs_saved_per_frame": round(
            (sync_syncs - pipe_syncs) / frames, 3),
        "pipelined_dispatches_per_frame": round(pipe_disp / frames, 3),
        "chunked_dispatches_per_frame": round(chunk_disp / frames, 3),
        "pipelined_us_per_frame": round(pipe_dt / frames * 1e6, 3),
        "chunked_us_per_frame": round(chunk_dt / frames * 1e6, 3),
        "note": "chunk_frames=8 row amortizes one dispatch over 8 frames "
                "(bit-identical logits); state, ring and counters are "
                "written in place, so no per-step buffer copies remain",
    }


@torch.no_grad()
def bench_sparse_fc(device: torch.device | str = "cuda"):
    """K4 ``sparse_fc`` (fused CSC zero-skip) against the materializing
    gather (``core.sparse.sparse_matmul`` of the merged trains) at the
    paper's deployed FC shape, 10 calls each (``time_us``); the derived row
    carries the sparsity of the weights and spikes timed."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    packed = sparse_lib.pack_model(params, cfg, ccfg,
                                   init_compression(params, ccfg))
    sc = packed.sparse["fc_w"]
    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(
        0, 2, (cfg.num_ts, 128, cfg.hidden_dim)).astype(np.float32)).to(device)

    def gather(s):
        return sparse_lib.sparse_matmul(s.sum(dim=0), sc)

    def fused(s):
        return ops.sparse_fc(s, sc.indices, sc.values, sc.scale)

    us_gather = time_us(gather, s, iters=10, device=device)
    us_fused = time_us(fused, s, iters=10, device=device)
    nnz = float((sc.values != 0).sum())
    return us_fused, {
        "kernel": _ran("sparse_fc", device),
        "us_jnp_gather": round(us_gather, 1),
        "speedup_vs_gather": round(us_gather / us_fused, 3),
        "sparsity_profile": {
            "fc_weight_density": round(
                nnz / (cfg.hidden_dim * cfg.fc_dim), 4),
            "nnz_max": int(sc.indices.shape[0]),
            "spike_density": round(float(s.mean()), 4),
        },
    }


@torch.no_grad()
def bench_nm_fc(device: torch.device | str = "cuda"):
    """K5 ``nm_fc`` (group-packed N:M) against K4 ``sparse_fc`` (padded
    CSC) on the same 2:4 mask at the paper's deployed FC shape: time (10
    calls each, ``time_us``) and packed bytes.  Equal nnz by construction,
    so the bytes isolate the index overhead of the regular layout (no
    global row ids, no padding).  K5 must equal K4 bit for bit (both sum
    each column's entries in ascending row order), on either device."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    spec = PruneSpec(kind="nm", n=2, m=4)
    mask = pruning.nm_prune_mask(params["fc_w"], spec.n, spec.m)
    q, scale = quantize_to_int(params["fc_w"])
    csc_l, nm_l = layouts.get_layout("csc"), layouts.get_layout("nm_group")
    sc = csc_l.pack(q, scale, keep=mask)
    nt = nm_l.pack(q, scale, keep=mask, spec=spec)

    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(
        0, 2, (cfg.num_ts, 128, cfg.hidden_dim)).astype(np.float32)).to(device)

    def fused_csc(s):
        return ops.sparse_fc(s, sc.indices, sc.values, sc.scale)

    def fused_nm(s):
        return ops.nm_fc(s, nt.packed, nt.scale, n=nt.n, m=nt.m)

    us_csc = time_us(fused_csc, s, iters=10, device=device)
    us_nm = time_us(fused_nm, s, iters=10, device=device)
    bit_identical = torch.equal(fused_csc(s), fused_nm(s))
    if not bit_identical:
        raise AssertionError("bench_nm_fc: nm_fc differs from sparse_fc on "
                             "the same 2:4 mask")
    k = cfg.hidden_dim
    return us_nm, {
        "kernel": _ran("nm_fc", device),
        "us_csc_kernel": round(us_csc, 1),
        "nnz": int(nt.count.sum()),
        "nm_group_bytes": nm_l.size_bytes(nt, k),
        "padded_csc_bytes": csc_l.size_bytes(sc, k),
        "bytes_saved_vs_csc": round(
            1.0 - nm_l.size_bytes(nt, k) / csc_l.size_bytes(sc, k), 4),
        "bit_identical_to_csc": bit_identical,
    }


def bench_stream_sharded(device: torch.device | str = "cuda"):
    """``ShardedStreamLoop`` over every visible device of ``device``'s
    type (one entry for ``cpu``) serving 8 seeded utterances of 40-100
    frames with the reference's model (``PRUNED`` from seed 0, the FC
    pruned 40%, int4, input scale 0.05, the default backend): microseconds
    a step, frames/s and the measured sparsity of the served traffic,
    after one warm-up utterance.  The wall clock, synchronized on the
    card."""
    device = resolve_device(device)
    devices = stream_mesh(None if device.type == "cuda" else [device])
    cfg = PRUNED
    engine = CompiledRSNN(cfg, _seeded_params(cfg, 0),
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


@torch.no_grad()
def bench_kernels(device: torch.device | str = "cuda"):
    """K3 ``merged_spike_fc`` (``kernels/ops.py``) on seeded (2, 128, 128)
    trains and a (128, 1920) int4 matrix at unit scale: microseconds a
    call (``time_us``).  ``derived["kernel"]`` names the version that ran
    (the reference times its jnp oracle)."""
    device = resolve_device(device)
    s, packed, scale = (torch.from_numpy(a).to(device)
                        for a in _merged_fc_inputs())
    us = time_us(ops.merged_spike_fc, s, packed, scale, device=device)
    return us, {"kernel": _ran("merged_spike_fc", device)}


def _merged_fc_inputs() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``bench_kernels``' operands as the reference draws them: 0/1 trains
    (2, 128, 128), int4 weights (128, 1920) packed two a byte along K (low
    nibble the even row) and a unit scale."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 2, (2, 128, 128)).astype(np.float32)
    q = rng.integers(-8, 8, (128, 1920)).astype(np.int8)
    packed = ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).astype(np.int8)
    return s, packed, np.ones((1920,), np.float32)


@torch.no_grad()
def bench_artifact_roundtrip(device: torch.device | str = "cuda"):
    """The deployment artifact's round trip (``core/artifact.py``): save
    and load of the int4 ``PRUNED`` model packed on ``device``
    (``time_us``, 5 calls; mostly host work, which CUDA events span on the
    card), the bytes on disk and the size report, and logits served from
    the artifact against logits of the in-process packing, which must be
    bit-equal on either device."""
    device = resolve_device(device)
    cfg = PRUNED
    params = _params(cfg, 0, device)
    ccfg = CompressionConfig(fc_prune_frac=0.4, weight_bits=4)
    cstate = init_compression(params, ccfg)
    packed = sparse_lib.pack_model(params, cfg, ccfg, cstate)

    with tempfile.TemporaryDirectory() as td:
        path = Path(td) / "artifact"

        def roundtrip():
            artifact_lib.save_artifact(path, cfg=cfg, packed=packed,
                                       ccfg=ccfg, input_scale=0.05,
                                       backend="jnp")
            return artifact_lib.load_artifact(path)

        us = time_us(roundtrip, iters=5, device=device)
        art = roundtrip()
        disk_bytes = sum(f.stat().st_size for f in path.iterdir())

        x = _seeded_normal((2, 10, cfg.input_dim), 1).to(device)
        mem = CompiledRSNN(cfg, params,
                           EngineConfig(precision="int4", input_scale=0.05),
                           ccfg, cstate, device=device)
        served = CompiledRSNN.from_artifact(path, device=device)
        lm, _, _ = mem.run(x)
        la, _, _ = served.run(x)
        bit_identical = torch.equal(lm, la)
    if not bit_identical:
        raise AssertionError("bench_artifact_roundtrip: artifact-served "
                             "logits differ from the in-process packing's")
    rep = art.size_report
    return us, {
        "bit_identical_vs_in_memory": bit_identical,
        "disk_bytes": disk_bytes,
        "broadcast_total_bytes": rep["broadcast_total_bytes"],
        "paper_fig12_bytes": 100864,
        "schema_version": art.manifest["schema_version"],
    }


# the reduced model of the mega-step, delta and spike-broadcast rows, its FC
# 2:4-pruned and stored as padded CSC
SMALL = RSNNConfig(input_dim=20, hidden_dim=64, fc_dim=192, num_ts=2)
SMALL_CCFG = CompressionConfig(weight_bits=4, prune_specs=(
    ("fc_w", PruneSpec(kind="nm", n=2, m=4, layout="csc")),))


def _small_engine(params: dict, device: torch.device, backend: str,
                  threshold: float = 0.0) -> CompiledRSNN:
    return CompiledRSNN(
        SMALL, params,
        EngineConfig(backend=backend, precision="int4", sparse_fc=True,
                     input_scale=0.05, delta_threshold=threshold),
        SMALL_CCFG, device=device)


def _frame_dispatches(engine: CompiledRSNN) -> int:
    """Op-table calls in one eager frame step (``_frame_step`` over 4 zero
    frames) with the table's entries wrapped in counters.

    Each call is at least one kernel launch on the card, so the count is
    the step's dispatch structure: 5 for the per-op tables (ff l0, cell
    l0, ff l1, cell l1, fc), 1 for ``fused``.  The reference counts the
    same calls while tracing the step."""
    count = 0

    def wrap(fn):
        if fn is None:
            return None

        def counted(*a, **k):
            nonlocal count
            count += 1
            return fn(*a, **k)

        return counted

    table = engine.ops
    engine.ops = table._replace(**{
        f: wrap(getattr(table, f)) for f in (
            "rsnn_cell", "ff_matmul", "fc", "delta_gate", "megastep")})
    try:
        state = engine.init_state(4)
        x = torch.zeros((4, engine.cfg.input_dim), device=engine.device)
        engine._frame_step(state, x)
    finally:
        engine.ops = table
    return count


@torch.no_grad()
def bench_megastep(device: torch.device | str = "cuda"):
    """The single-launch mega-step (``fused``, K6) against the per-op
    tables (``jnp``; ``pallas``: K1, K2 and K4) on the same packed int4
    model (``SMALL``, FC 2:4 as CSC) at 4 slots: op-table dispatches a
    frame (``_frame_dispatches``) and the p50 of 30 fenced wall-clock
    step times (``_p50_us``).  On the card each backend also reports the
    kernel launches of one step (``kernels/ops.py`` counters).

    The dispatch count is the structural claim: ``fused`` runs the whole
    frame step (both cells, the stimulus products, the zero-skip FC, the
    sparsity counters) as one kernel launch a frame."""
    device = resolve_device(device)
    params = _params(SMALL, 0, device)
    x = _seeded_normal((4, SMALL.input_dim), 1).to(device)

    per_backend = {}
    for backend in ("jnp", "pallas", "fused"):
        engine = _small_engine(params, device, backend)
        dispatches = _frame_dispatches(engine)
        state = engine.init_state(4)
        xq = engine.quantize_features(x)

        def step():
            return engine.step(state, xq)

        p50 = _p50_us(step, device)
        before = ops.launch_counts()
        step()
        launched = {k: n - before[k] for k, n in ops.launch_counts().items()
                    if n != before[k]}
        per_backend[backend] = {"dispatches_per_frame": dispatches,
                                "p50_us": p50,
                                "launches_per_step": launched}

    us = per_backend["fused"]["p50_us"]
    return us, {
        **per_backend,
        "dispatch_collapse":
            f"{per_backend['jnp']['dispatches_per_frame']} -> "
            f"{per_backend['fused']['dispatches_per_frame']} per frame",
    }


def _serve(engine: CompiledRSNN, utts: list):
    """``utts`` through a v1 ``StreamLoop`` of 2 slots: (logits of every
    frame in stream order, the loop)."""
    loop = StreamLoop(engine, batch_slots=2, pipeline_depth=0)
    for u in utts:
        loop.submit(u)
    done = sorted(loop.run(), key=lambda r: r.sid)
    return np.concatenate([r.stacked_logits() for r in done]), loop


@torch.no_grad()
def bench_delta(device: torch.device | str = "cuda"):
    """Delta-temporal zero skipping (the ``delta`` backend: K8
    ``delta_step``, K10 ``spike_cell``): a threshold sweep (0, 1, 4, 16
    LSBs of the quantized input) over 4 slowly varying random-walk
    utterances of 24 frames, each served by a v1 loop of 2 slots: the
    measured delta input density, the MMAC/s the complexity model charges
    at the measured densities (paper frame rate, so deterministic, not
    timing noise), and the argmax agreement with the ``jnp`` logits; then
    the p50 of 30 fenced wall-clock steps of the threshold-0 engine.

    The MMAC/s must not rise as the threshold grows.  Threshold 0 skips
    only exact quantized repeats, so it computes ``jnp``'s function: on
    the CPU its logits must equal ``jnp``'s bit for bit; on the card they
    are compared and reported (``thr_0``'s ``bit_identical`` and
    ``max_abs_logit_diff``)."""
    device = resolve_device(device)
    params = _params(SMALL, 0, device)

    # random walks: frame-to-frame deltas are small against the feature
    # range, the regime the EdgeDRNN gating targets
    rng = np.random.default_rng(7)
    utts = []
    for _ in range(4):
        steps = 0.02 * rng.normal(size=(24, SMALL.input_dim))
        steps[0] = 0.5 * rng.normal(size=SMALL.input_dim)
        utts.append(np.cumsum(steps, axis=0).astype(np.float32))

    base_logits, _ = _serve(_small_engine(params, device, "jnp"), utts)
    sweep = {}
    timed_engine = None
    prev_mmac = None
    for thr in (0.0, 1.0, 4.0, 16.0):
        engine = _small_engine(params, device, "delta", thr)
        logits, loop = _serve(engine, utts)
        prof, mmac = loop.sparsity_profile(), loop.mmac_per_second()
        against = _against(logits, base_logits)
        if thr == 0.0:
            if device.type == "cpu" and not against["bit_identical"]:
                raise AssertionError("bench_delta: threshold 0 differs from "
                                     "jnp on the CPU")
            timed_engine = engine
        if prev_mmac is not None and mmac > prev_mmac + 1e-9:
            raise AssertionError(f"bench_delta: MMAC/s rose from "
                                 f"{prev_mmac} to {mmac} at threshold {thr}")
        prev_mmac = mmac
        sweep[f"thr_{thr:g}"] = {
            "delta_input_density": round(float(prof.delta_input_density), 4),
            "mmac_per_s": round(mmac, 3),
            **({k: against[k] for k in ("bit_identical",
                                          "max_abs_logit_diff")}
               if thr == 0.0 else {}),
            "argmax_agreement": against["argmax_agreement"],
        }

    state = timed_engine.init_state(2)
    xq = timed_engine.quantize_features(utts[0][:2])
    us = _p50_us(lambda: timed_engine.step(state, xq), device)
    return us, {
        "thresholds": sweep,
        "bit_identical_at_thr0": sweep["thr_0"]["bit_identical"],
        "note": "threshold in quantized-input LSBs; MMAC/s analytic from "
                "measured delta density at the paper frame rate",
    }


@torch.no_grad()
def bench_spike_broadcast(device: torch.device | str = "cuda"):
    """The event-driven spike path (``spike``: K10 cells, K9 L1
    feed-forward, K4 readout; ``fused_spike``: K7) against ``jnp`` and
    ``fused`` (K6): 4 seeded utterances of 24 frames served through each
    by a v1 loop of 2 slots; the MEASURED spike densities of the ``spike``
    run next to the analytic ``SparsityProfile`` defaults (0.38 a time
    step, 0.46 union), the gathered and dense accumulates a frame
    (``complexity.spike_broadcast_report``), and each backend's p50 of 30
    fenced wall-clock steps.

    The gathered count at the measured sparsity must lie strictly below
    the dense count (the zero-skip claim as an inequality, from the
    density accounting).  ``fused_spike`` must equal ``fused`` bit for
    bit on either device; ``spike``, ``fused`` and ``fused_spike`` compute
    ``jnp``'s function and must equal it bit for bit on the CPU, and on
    the card each backend reports ``bit_identical``, ``max_abs_logit_diff``
    and ``argmax_agreement`` against it."""
    device = resolve_device(device)
    params = _params(SMALL, 0, device)
    rng = np.random.default_rng(11)
    utts = [rng.normal(size=(24, SMALL.input_dim)).astype(np.float32)
            for _ in range(4)]

    base_logits, _ = _serve(_small_engine(params, device, "jnp"), utts)
    per_backend, served = {}, {}
    prof = None
    for backend in ("jnp", "spike", "fused", "fused_spike"):
        engine = _small_engine(params, device, backend)
        logits, loop = _serve(engine, utts)
        served[backend] = logits
        against = _against(logits, base_logits)
        if device.type == "cpu" and not against["bit_identical"]:
            raise AssertionError(f"bench_spike_broadcast: {backend} differs "
                                 f"from jnp on the CPU")
        if backend == "spike":
            prof = loop.sparsity_profile()  # the served spikes' densities
        state = engine.init_state(2)
        xq = engine.quantize_features(utts[0][:2])
        per_backend[backend] = {
            "p50_us": _p50_us(lambda: engine.step(state, xq), device),
            **against}
    if not np.array_equal(served["fused"], served["fused_spike"]):
        raise AssertionError("bench_spike_broadcast: fused_spike differs "
                             "from fused")

    measured = C.spike_broadcast_report(SMALL, SMALL.num_ts, sparsity=prof)
    analytic = C.spike_broadcast_report(SMALL, SMALL.num_ts)  # Fig. 18
    # the acceptance gate: gathering beats dense at the served sparsity
    if not measured["gathered"] < measured["dense"]:
        raise AssertionError(f"bench_spike_broadcast: gathered "
                             f"{measured['gathered']} >= dense "
                             f"{measured['dense']}")

    def _round(d):
        return {k: round(v, 4) for k, v in d.items()}

    us = per_backend["spike"]["p50_us"]
    return us, {
        **per_backend,
        "measured_density": {
            "l0": [round(d, 4) for d in prof.l0_density],
            "l1": [round(d, 4) for d in prof.l1_density],
            "fc_union": round(prof.fc_union_density, 4),
        },
        "analytic_density": {"l0": [0.38, 0.38], "l1": [0.38, 0.38],
                             "fc_union": 0.46},
        "accumulates_per_frame_measured": _round(measured),
        "accumulates_per_frame_analytic": _round(analytic),
        "bit_identical_to_jnp": all(
            per_backend[b]["bit_identical"] for b in per_backend),
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
