#!/usr/bin/env python3
"""Drive the repro_torch serving path on one GPU and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--seed 0] [--kernels-only]

Phases, each printed on its own line:

  1. the card (``nvidia-smi`` name and power limit) and the kernel build;
  2. each kernel (K1 rsnn_cell, K2 int4_matmul, K3 merged_spike_fc, K4
     sparse_fc) against its plain version on the card at the main path's
     shapes, B = 256 and a ragged B = 200: K2-K4 bit for bit
     (``torch.equal``), K1 within ``U_RTOL``/``U_ATOL`` on the membrane
     potential, with a spike allowed to differ only where the plain
     version's potential lies within that tolerance of the threshold;
  3. a PRUNED int4 artifact (40 -> 128 -> 128 -> 1920, TS = 2, FC pruned
     40% into padded CSC) made from ``--seed`` with numpy and written in
     the reference's schema-v2 format;
  4. 512 seeded utterances of 40-100 frames served through
     ``StreamLoop(batch_slots=256, pipeline_depth=0)`` with backend
     ``pallas`` and with backend ``sparse``; every kernel's launch count
     must equal steps x launches per step; the two backends' logits must be
     bit-equal (the dense and CSC readouts hold the same int4 matrix and
     sum integers); each is compared with the port's ``ref`` backend on
     the card: argmax agreement and spike-flip rate are printed, and a
     teacher-forced run of frames is asserted: a slot's spikes may differ
     only where the ``ref`` engine's potential lies within ``U_RTOL``/
     ``U_ATOL`` of the threshold (those slots are counted and printed),
     and the other slots' logits and potentials must agree within
     ``LOGIT_ATOL``;
  5. frames/s; the device busy share of one more run of each backend
     under ``torch.profiler``, with the device operations that took most
     of it; each kernel's mean time per frame at B = 256 from CUDA
     events beside its plain version, a PyTorch library yardstick and the
     H100 bound: the larger of bytes over 3.35 TB/s and operations over
     the peak rate of their type (float32 outside the tensor cores, 67
     TFLOP/s, for K1's dequantized weights; int8, 1,979 TOP/s, for K2-K4,
     whose operands are 8-bit integers, spikes and int4 weights).

Then the kernel JSON line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line.  The script imports neither
JAX nor the JAX package: the machine with the card has no JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.rsnn_timit import PRUNED  # noqa: E402
from repro_torch.core.rsnn import RSNNConfig  # noqa: E402

U_RTOL = 1e-5  # K1: order-dependent float32 recurrent sum
U_ATOL = 1e-5
LOGIT_ATOL = 1e-4  # cuda vs ref backend, teacher-forced frames
STREAMS = 512  # utterances served per backend
SLOTS = 256  # StreamLoop batch slots
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# Peak operation rate of each kernel's operand type (H100 SXM data sheet,
# dense): K1 multiplies float32 dequantized weights, which neither TF32 nor
# int8 holds exactly; K2-K4 multiply 8-bit integer inputs or spikes by int4
# weights, exact on the int8 tensor cores.
PEAK_OPS_PER_S = {"rsnn_cell": 67e12, "int4_matmul": 1979e12,
                  "merged_spike_fc": 1979e12, "sparse_fc": 1979e12}
LAYERS = ("l0_wx", "l0_wh", "l1_wx", "l1_wh", "fc_w")
# uniform half-width of the float weights before int4 quantization, per
# layer, chosen so that both layers fire at moderate rates on N(0, 1)
# features quantized to 8 bits
WEIGHT_RANGE = {"l0_wx": 0.02, "l0_wh": 0.15, "l1_wx": 0.3,
                "l1_wh": 0.15, "fc_w": 0.1}


# ------------------------------------------------------------- the artifact


def _pack_int4(q: np.ndarray) -> np.ndarray:
    """(2k, n) ints in [-8, 7] -> (k, n) int8, low nibble = even row."""
    lo = q[0::2].astype(np.uint8) & 0xF
    hi = (q[1::2].astype(np.uint8) & 0xF) << 4
    return (lo | hi).view(np.int8)


def _quantize(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int4: (q in [-8, 7], scale (1, N))."""
    scale = (np.maximum(np.abs(w).max(axis=0, keepdims=True), 1e-8)
             / 7.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -8, 7).astype(np.int8)
    return q, scale


def _csc(q: np.ndarray, keep: np.ndarray) -> dict[str, np.ndarray]:
    """Padded CSC of the kept entries: kept rows first, in row order; pad
    entries are (index 0, value 0)."""
    nnz_max = max(int(keep.sum(axis=0).max()), 1)
    order = np.argsort(~keep, axis=0, kind="stable")[:nnz_max]
    taken = np.take_along_axis(keep, order, axis=0)
    return {"indices": np.where(taken, order, 0).astype(np.int32),
            "values": np.where(taken, np.take_along_axis(q, order, axis=0),
                               0).astype(np.float32),
            "count": keep.sum(axis=0).astype(np.int32)}


def write_artifact(path: Path, seed: int, features: list[np.ndarray],
                   cfg: RSNNConfig = PRUNED, prune: float = 0.4) -> Path:
    """Write a seeded int4 artifact in the reference's schema-v2 format:
    random weights quantized per channel to int4, ``fc_w`` pruned
    ``prune`` at random and stored also as padded CSC, power-of-two LIF
    constants, and the max-abs 8-bit input scale of ``features``."""
    rng = np.random.default_rng(seed)
    flat: dict[str, np.ndarray] = {}
    report: dict = {}
    for name, (k, n) in cfg.layer_shapes.items():
        a = WEIGHT_RANGE[name]
        q, scale = _quantize(rng.uniform(-a, a, (k, n)).astype(np.float32))
        entry = {"dense_int4": k * n * 4 / 8.0}
        if name == "fc_w":
            keep = rng.random((k, n)) >= prune
            q = np.where(keep, q, 0).astype(np.int8)
            for field, arr in _csc(q, keep).items():
                flat[f"csc.{name}.{field}"] = arr
            flat[f"csc.{name}.scale"] = scale
            index_bits = max(int(np.ceil(np.log2(max(k, 2)))), 1)
            stored = float(keep.sum())
            entry.update(layout="csc", csc_int4=stored * (4 + index_bits) / 8,
                         nnz_int4=stored * 4 / 8)
        else:
            entry["nnz_int4"] = entry["dense_int4"]
        flat[f"quant.{name}.packed"] = _pack_int4(q)
        flat[f"quant.{name}.scale"] = scale
        report[name] = entry
    h = cfg.hidden_dim
    for i in (0, 1):
        flat[f"lif.beta{i}"] = rng.choice(
            np.float32([0.5, 0.75, 0.875]), h).astype(np.float32)
        flat[f"lif.vth{i}"] = np.full((h,), 1.0, np.float32)
    amax = max(float(np.abs(f).max()) for f in features)
    flat["input_scale"] = np.asarray(np.float32(max(amax, 1e-8))
                                     / np.float32(127.0), np.float32)
    report["total_bytes"] = sum(min(e["dense_int4"], e.get("csc_int4", 1e30))
                                for e in report.values())
    report["broadcast_total_bytes"] = sum(e["nnz_int4"]
                                          for e in list(report.values())[:-1])
    manifest = {
        "schema_version": 2,
        "precision": "int4",
        "rsnn_config": {**dataclasses.asdict(cfg), "dtype": "float32"},
        "compression_config": {
            "fc_prune_frac": prune, "prune_names": ["fc_w"],
            "prune_specs": [], "weight_bits": 4,
            "quant_names": list(LAYERS),
            "quant_granularity": "per_channel"},
        "sparsity_profile": None,
        "size_report": report,
        "backend": "pallas",
        "sparse_fc": False,
        "layouts": {"fc_w": "csc"},
        "has_input_scale": True,
        "tensors": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in flat.items()},
    }
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "tensors.npz", **flat)
    (path / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return path


def utterances(seed: int, count: int, cfg: RSNNConfig = PRUNED
               ) -> list[np.ndarray]:
    """``count`` seeded N(0, 1) feature sequences of 40-100 frames."""
    rng = np.random.default_rng(seed + 1)
    return [rng.standard_normal((int(t), cfg.input_dim)).astype(np.float32)
            for t in rng.integers(40, 101, size=count)]


# -------------------------------------------------------- kernel checks


def lif_trace(stim: torch.Tensor, rec: torch.Tensor, u0, h0, beta, vth):
    """Per-time-step membrane potentials of the plain LIF chain
    (``rsnn_cell_ref``'s order), to find spikes near the threshold."""
    u, h, trace = u0, h0, []
    for t in range(stim.shape[0]):
        u = (stim[t] + rec[t]) + beta * u * (1.0 - h)
        h = (u >= vth).to(u.dtype)
        trace.append(u)
    return torch.stack(trace)


def check_cell(got, want, stim, s_prev, w, u0, h0, beta, vth) -> float:
    """K1 within tolerance: u close where the spike trains agree; a spike
    may differ only where the plain potential is within tolerance of the
    threshold at some time step.  Returns the largest |du| kept."""
    (s_k, u_k), (s_p, u_p) = got, want
    trace = lif_trace(stim, torch.matmul(s_prev, w), u0, h0, beta, vth)
    near = ((trace - vth).abs() <= U_ATOL + U_RTOL * vth.abs()).any(dim=0)
    flipped = (s_k != s_p).any(dim=0)
    if bool((flipped & ~near).any()):
        raise AssertionError("rsnn_cell: a spike differs away from the "
                             "threshold")
    ok = ~(flipped | near)
    du = (u_k - u_p).abs()[ok]
    lim = (U_ATOL + U_RTOL * u_p.abs())[ok]
    if bool((du > lim).any()):
        raise AssertionError(f"rsnn_cell: |du| up to {float(du.max())}")
    return float(du.max()) if du.numel() else 0.0


def kernel_inputs(packed, b: int, gen: torch.Generator, dev) -> dict:
    """Main-path operands for batch ``b``: int4 weights of the artifact,
    8-bit integer inputs, random 0/1 spikes and membrane state."""
    from repro_torch.core.sparse import dequantize

    cfg = PRUNED
    ts, h, d = cfg.num_ts, cfg.hidden_dim, cfg.input_dim

    def spikes(*shape):
        return (torch.rand(shape, generator=gen) < 0.3).float().to(dev)

    def q(name):
        return packed.quant[name].packed.to(dev), \
            packed.quant[name].scale.reshape(-1).to(dev)

    x = torch.randint(-128, 128, (b, d), generator=gen).float().to(dev)
    ff0 = (torch.randn((b, h), generator=gen) * 0.8).to(dev)
    csc = packed.sparse["fc_w"]
    return {
        "x": x, "l0": q("l0_wx"), "l1": q("l1_wx"), "fc": q("fc_w"),
        "csc": (csc.indices.to(dev), csc.values.to(dev),
                csc.scale.reshape(-1).to(dev)),
        "stim0": ff0.unsqueeze(0).expand(ts, b, h),
        "stim1": (torch.randn((ts, b, h), generator=gen) * 0.8).to(dev),
        "s0": spikes(ts, b, h), "s1": spikes(ts, b, h),
        "w0h": dequantize(packed.quant["l0_wh"]).to(dev),
        "w1h": dequantize(packed.quant["l1_wh"]).to(dev),
        "u0": torch.randn((b, h), generator=gen).to(dev),
        "h0": spikes(b, h),
        "beta": packed.lif["beta0"].to(dev), "vth": packed.lif["vth0"].to(dev),
    }


def kernel_calls(a: dict) -> dict:
    """Each kernel's calls of one frame on operands ``a``: name ->
    list of (kernel, plain, args).  Imported late: the module needs the
    package on ``sys.path``."""
    from repro_torch.kernels import (int4_matmul, merged_spike_fc, ref,
                                     rsnn_cell, sparse_fc)

    cell = (a["u0"], a["h0"], a["beta"], a["vth"])
    return {
        "rsnn_cell": [
            (rsnn_cell.rsnn_cell, ref.rsnn_cell_ref,
             (a["stim0"], a["s0"], a["w0h"], *cell)),
            (rsnn_cell.rsnn_cell, ref.rsnn_cell_ref,
             (a["stim1"], a["s1"], a["w1h"], *cell))],
        "int4_matmul": [
            (int4_matmul.int4_matmul, ref.int4_matmul_ref,
             (a["x"], *a["l0"])),
            (int4_matmul.int4_matmul, ref.int4_matmul_ref,
             (a["s0"].reshape(-1, a["s0"].shape[-1]), *a["l1"]))],
        "merged_spike_fc": [
            (merged_spike_fc.merged_spike_fc, ref.merged_spike_fc_ref,
             (a["s1"], *a["fc"]))],
        "sparse_fc": [
            (sparse_fc.sparse_fc, ref.sparse_fc_ref, (a["s1"], *a["csc"]))],
    }


def check_kernels(packed, dev, seed: int) -> dict[str, float]:
    """Phase 2: every kernel against its plain version on the card."""
    errs: dict[str, float] = {}
    gen = torch.Generator().manual_seed(seed)
    for b in (256, 200):
        calls = kernel_calls(kernel_inputs(packed, b, gen, dev))
        for name, items in calls.items():
            for kern, plain, args in items:
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if name == "rsnn_cell":
                    err = check_cell(got, want, *args)
                elif not torch.equal(got, want):
                    raise AssertionError(
                        f"{name}: not bit-equal to its plain version at "
                        f"B={b}: max |diff| "
                        f"{float((got - want).abs().max())}")
                else:
                    err = 0.0
                errs[name] = max(errs.get(name, 0.0), err)
            print(f"check {name} B={b}: ok, max_abs_err {errs[name]!r}")
    return errs


# ---------------------------------------------------------------- serving


def serve(engine, utts):
    """One StreamLoop run; returns (loop, finished requests, seconds)."""
    from repro_torch.serving.stream import StreamLoop

    loop = StreamLoop(engine, batch_slots=SLOTS, pipeline_depth=0)
    for u in utts:
        loop.submit(u)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = loop.run()
    torch.cuda.synchronize()
    return loop, done, time.perf_counter() - t0


def compare_free_running(eng, ref_eng, utts, frames: int):
    """Step both engines ``frames`` frames on the first utterances, each
    from its own state: the spike-flip rate between the two."""
    b = len(utts)
    x = torch.from_numpy(np.stack([u[:frames] for u in utts], 1))
    sa, sb = eng.init_state(b), ref_eng.init_state(b)
    flips = total = 0
    for t in range(frames):
        xq = eng.quantize_features(x[t])
        sa, _, _ = eng.step(sa, xq)
        sb, _, _ = ref_eng.step(sb, xq)
        for p, q in ((sa.h0, sb.h0), (sa.h1, sb.h1)):
            flips += int((p != q).sum())
            total += p.numel()
    return flips / total


def near_threshold(ref_eng, state, xq, ref_next) -> list[torch.Tensor]:
    """Per slot, for L0 and L1: whether the ``ref`` engine's step from
    ``state`` on ``xq`` brings some neuron within ``U_RTOL``/``U_ATOL`` of
    its threshold at some time step.  Recomputes the step's membrane
    trace with the engine's own plain operations and checks that its
    spikes are those of ``ref_next``, the engine's next state."""
    ff, w, lif = ref_eng.ops.ff_matmul, ref_eng._w, ref_eng._lif
    ts, b, h = state.h0.shape[0], xq.shape[0], ref_eng.cfg.hidden_dim
    stim = ff(xq, "l0_wx").unsqueeze(0).expand(ts, b, h)
    near = []
    for i, (h_prev, lif_prev, s_next) in enumerate(
            ((state.h0, state.lif0, ref_next.h0),
             (state.h1, state.lif1, ref_next.h1))):
        beta, vth = lif[f"beta{i}"], lif[f"vth{i}"]
        trace = lif_trace(stim, torch.matmul(h_prev, w[f"l{i}_wh"]),
                          lif_prev.u, lif_prev.spike, beta, vth)
        spikes = (trace >= vth).float()
        if not torch.equal(spikes, s_next):
            raise AssertionError(f"near_threshold: the L{i} trace does not "
                                 f"reproduce the ref engine's spikes")
        near.append(((trace - vth).abs() <= U_ATOL + U_RTOL * vth.abs())
                    .any(dim=0).any(dim=1))
        stim = ff(spikes.reshape(ts * b, h), "l1_wx").reshape(ts, b, h)
    return near


def teacher_forced(eng, ref_eng, utts, frames: int) -> tuple[float, int]:
    """Each frame, both engines start from the ref engine's state.  A slot's
    spikes may differ only where the ref engine's potential is within
    tolerance of the threshold (in L0, or in L1 with equal L0 spikes);
    every other slot's logits and u must agree within tolerance.  Returns
    (largest logit difference, slot-frames let through near threshold)."""
    b = len(utts)
    x = torch.from_numpy(np.stack([u[:frames] for u in utts], 1))
    state = ref_eng.init_state(b)
    worst, let_through = 0.0, 0
    for t in range(frames):
        xq = ref_eng.quantize_features(x[t])
        sa, la, _ = eng.step(state, xq)
        sb, lb, _ = ref_eng.step(state, xq)
        near0, near1 = near_threshold(ref_eng, state, xq, sb)
        diff0 = (sa.h0 != sb.h0).any(dim=0).any(dim=1)
        diff1 = (sa.h1 != sb.h1).any(dim=0).any(dim=1)
        bad = (diff0 & ~near0) | (diff1 & ~diff0 & ~near1)
        if bool(bad.any()):
            raise AssertionError(
                f"teacher-forced frame {t}: spikes differ away from the "
                f"threshold in {int(bad.sum())} of {b} slots")
        same = ~(diff0 | diff1)
        let_through += int((~same).sum())
        if bool(same.any()):
            d = float((la - lb)[same].abs().max())
            du = max(float((p.u - q.u)[same].abs().max())
                     for p, q in ((sa.lif0, sb.lif0), (sa.lif1, sb.lif1)))
            if d > LOGIT_ATOL or du > LOGIT_ATOL:
                raise AssertionError(f"teacher-forced frame {t}: |dlogit| "
                                     f"{d}, |du| {du}")
            worst = max(worst, d)
        state = sb
    return worst, let_through


def device_busy(engine, utts, backend: str) -> None:
    """Phase 5: one StreamLoop run under ``torch.profiler``; prints the
    share of its wall time in which the card ran a kernel or a copy, and
    the device operations that took most of it.  The profiler slows the
    host, so the share is a lower bound for the unprofiled loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop, _, secs = serve(engine, utts)
    ops = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _, _ in ops)
    if busy_us <= 0:
        print("device busy share: not measured (the profiler recorded no "
              "device time)")
        return
    top = "; ".join(f"{k[:48]} x{c} {t / 1e3:.3f} ms"
                    for t, c, k in sorted(ops, reverse=True)[:8])
    print(f"device busy share ({backend}, profiled): "
          f"{busy_us / 1e6 / secs!r} of {secs!r} s over {loop.steps} "
          f"steps; device ms/step {busy_us / 1e3 / loop.steps!r}; top: {top}")


# ----------------------------------------------------------------- timing


def cuda_ms(fn, args, reps: int = 200) -> float:
    """Mean time of ``fn(*args)`` from CUDA events over ``reps`` calls."""
    for _ in range(10):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def work(name: str, args) -> tuple[int, float]:
    """(bytes moved, operations) of one kernel call on ``args``:
    each input read once (a broadcast stimulus counts its one row), each
    output written once; the sparse readout counts the stored entries."""
    if name == "rsnn_cell":
        stim, s, w, u0, h0, beta, vth = args
        ts, b, h = s.shape
        stim_b = b * h * 4 if stim.stride(0) == 0 else nbytes(stim)
        return (stim_b + nbytes(s, w, u0, h0, beta, vth) + nbytes(s, u0),
                2.0 * ts * b * h * h + 5.0 * ts * b * h)
    if name == "int4_matmul":
        x, p, sc = args
        m, k = x.shape
        n = p.shape[1]
        return nbytes(x, p, sc) + m * n * 4, 2.0 * m * k * n
    if name == "merged_spike_fc":
        s, p, sc = args
        ts, b, h = s.shape
        n = p.shape[1]
        return (nbytes(s, p, sc) + b * n * 4,
                (ts - 1.0) * b * h + 2.0 * b * h * n)
    s, idx, val, sc = args
    ts, b, h = s.shape
    stored = float((val != 0).sum())
    return (nbytes(s, idx, val, sc) + b * idx.shape[1] * 4,
            (ts - 1.0) * b * h + 2.0 * b * stored)


def library_fn(name: str, args):
    """One PyTorch call computing (close to) the same function, timed as a
    yardstick only: the port never calls it.  None where there is none."""
    if name == "int4_matmul":
        from repro_torch.kernels.ref import unpack_int4_ref

        x, p, sc = args
        w = unpack_int4_ref(p).float() * sc
        return torch.matmul, (x, w)
    if name == "merged_spike_fc":
        from repro_torch.kernels.ref import unpack_int4_ref

        s, p, sc = args
        w = unpack_int4_ref(p).float() * sc
        return (lambda s_, w_: torch.einsum("tbh,hn->bn", s_, w_)), (s, w)
    if name == "sparse_fc":
        s, idx, val, sc = args
        h, n = s.shape[-1], idx.shape[1]
        dense = torch.zeros((h, n), device=s.device)
        cols = torch.arange(n, device=s.device).expand_as(idx)
        dense.index_put_((idx.long(), cols), val * sc.reshape(1, -1),
                         accumulate=True)
        with warnings.catch_warnings():  # CSR support is marked beta
            warnings.simplefilter("ignore", UserWarning)
            wt = dense.t().contiguous().to_sparse_csr()  # (N, H)
        merged_t = s.sum(dim=0).t().contiguous()
        return torch.sparse.mm, (wt, merged_t)
    return None


def time_kernels(packed, dev, seed: int, launches: dict, errs: dict):
    """Phase 5: per-frame time of each kernel at B = 256."""
    gen = torch.Generator().manual_seed(seed + 7)
    calls = kernel_calls(kernel_inputs(packed, 256, gen, dev))
    rows = []
    src = {"rsnn_cell": ("rsnn_cell.cu", "src/repro/kernels/rsnn_cell.py:53"),
           "int4_matmul": ("int4_matmul.cu",
                           "src/repro/kernels/int4_matmul.py:65"),
           "merged_spike_fc": ("merged_spike_fc.cu",
                               "src/repro/kernels/merged_spike_fc.py:43"),
           "sparse_fc": ("sparse_fc.cu", "src/repro/kernels/sparse_fc.py:69")}
    for name, items in calls.items():
        ms = plain_ms = bound = 0.0
        lib_ms: float | None = 0.0
        for kern, plain, args in items:
            ms += cuda_ms(kern, args)
            plain_ms += cuda_ms(plain, args)
            by, ops = work(name, args)
            bound += max(by / HBM_BYTES_PER_S,
                         ops / PEAK_OPS_PER_S[name]) * 1e3
            lib = library_fn(name, args)
            lib_ms = None if lib is None or lib_ms is None else \
                lib_ms + cuda_ms(*lib)
        by_bytes = all(
            work(name, a)[0] / HBM_BYTES_PER_S
            >= work(name, a)[1] / PEAK_OPS_PER_S[name] for _, _, a in items)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src[name][0]}",
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes" if by_bytes else
            "operations", "library_ms": lib_ms})
        print(f"time {name} (per frame, B=256, {len(items)} call(s)): "
              f"{ms!r} ms, plain {plain_ms!r} ms, library {lib_ms!r} ms, "
              f"bound {bound!r} ms")
    return rows


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch.core.artifact import load_artifact
    from repro_torch.kernels import (_build, int4_matmul, merged_spike_fc,
                                     rsnn_cell, sparse_fc)
    from repro_torch.serving.stream import CompiledRSNN

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0!r} s (nvcc "
          f"{_build.build_seconds!r} s)")

    utts = utterances(args.seed, STREAMS)
    with tempfile.TemporaryDirectory() as tmp:
        path = write_artifact(Path(tmp) / "art", args.seed, utts)
        art = load_artifact(path)
        print(f"artifact: {path.name} cfg {art.cfg} fc nnz_max "
              f"{art.packed.sparse['fc_w'].indices.shape[0]}")
        errs = check_kernels(art.packed, dev, args.seed)
        if args.kernels_only:
            return 0

        ref = CompiledRSNN.from_artifact(path, backend="ref")
        _, ref_done, ref_s = serve(ref, utts)
        ref_logits = [r.stacked_logits() for r in ref_done]
        modules = {"rsnn_cell": rsnn_cell, "int4_matmul": int4_matmul,
                   "merged_spike_fc": merged_spike_fc, "sparse_fc": sparse_fc}
        per_step = {"pallas": {"rsnn_cell": 2, "int4_matmul": 2,
                               "merged_spike_fc": 1, "sparse_fc": 0},
                    "sparse": {"rsnn_cell": 2, "int4_matmul": 2,
                               "merged_spike_fc": 0, "sparse_fc": 1}}
        launches = dict.fromkeys(modules, 0)
        served = {}
        for backend, expect in per_step.items():
            eng = CompiledRSNN.from_artifact(path, backend=backend)
            for m in modules.values():
                m.launches = 0
            loop, done, secs = serve(eng, utts)
            counts = {n: m.launches for n, m in modules.items()}
            for n, c in counts.items():
                if c != loop.steps * expect[n]:
                    raise AssertionError(
                        f"{backend}: {n} launched {c} times, expected "
                        f"{loop.steps} steps x {expect[n]}")
                launches[n] += c
            logits = [r.stacked_logits() for r in done]
            for r, lg in zip(done, logits):
                if lg.shape != (len(r.frames), PRUNED.fc_dim) \
                        or not np.isfinite(lg).all():
                    raise AssertionError(f"{backend}: request {r.sid} "
                                         f"logits {lg.shape} not finite")
            agree = float(np.mean(np.concatenate(
                [a.argmax(1) == b.argmax(1)
                 for a, b in zip(logits, ref_logits)])))
            flips = compare_free_running(eng, ref, utts[:SLOTS], 40)
            tf, tf_near = teacher_forced(eng, ref, utts[:SLOTS], 16)
            prof = loop.sparsity_profile()
            print(f"serve {backend}: {len(done)} streams, {loop.steps} "
                  f"steps, {loop.frames_served} frames in {secs!r} s = "
                  f"{loop.frames_served / secs!r} frames/s; launches "
                  f"{counts}; argmax agreement with ref {agree!r}; spike "
                  f"flip rate {flips!r}; teacher-forced max |dlogit| "
                  f"{tf!r}, slot-frames let through near the threshold "
                  f"{tf_near}; L0/L1 density {prof.l0_density}/"
                  f"{prof.l1_density}")
            served[backend] = logits
            device_busy(eng, utts, backend)
        print(f"serve ref: {ref_s!r} s = "
              f"{sum(map(len, utts)) / ref_s!r} frames/s")
        for a, b in zip(served["pallas"], served["sparse"]):
            if not np.array_equal(a, b):
                raise AssertionError("pallas and sparse logits differ")
        print("serve: pallas and sparse logits bit-equal")
        rows = time_kernels(art.packed, dev, args.seed, launches, errs)

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if leaked:
        raise AssertionError(f"JAX or the JAX package was imported: {leaked}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
