"""K1 wrapper: fused recurrent spiking layer (``csrc/rsnn_cell.cu``).

Replaces ``src/repro/kernels/rsnn_cell.py`` ``rsnn_cell`` (its
``pl.pallas_call`` at line 53).  The plain version is
``ref.rsnn_cell_ref``; it agrees within the tolerance stated in
``chip_smoke.py`` and the tests, since the recurrent sum of float32
weights depends on its order.  ``launches`` counts the kernel launches of
this process; ``tile_plan`` chooses the kernel's tiles for each shape.

A block owns ``rows`` x ``cols`` outputs, stages W's column tile and its
rows' spike trains into shared memory with ``cp.async``, and gives each
thread 1 row x TS x 2 neurons of accumulators, each one ``fmaf`` chain in
ascending k.  Bytes bound a call on the H100 (about 1.2 MB at B = 256,
H = 128, TS = 2: 0.35 us); the launch and one round of staging set its
time (PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
         + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

ROWS = (4, 8, 16, 32)  # batch rows a block
COLS = (16, 32, 64)  # neurons a block
THREAD_TILE = 2  # outputs a thread owns at each time step: 1 row x 2


def shared_bytes(ts: int, rows: int, cols: int, h: int) -> int:
    """A block's shared memory as ``CellLayout`` computes it: W's column
    tile (k padded to a multiple of 4) and the rows' ``ts`` trains, each
    row 4 floats longer."""
    kp = -(-h // 4) * 4
    return 4 * (kp * cols + ts * rows * (kp + 4))


def tile_plans(ts: int, b: int, h: int) -> list[_build.TilePlan]:
    """Every tile plan K1's launch takes for ``ts`` trains of ``b`` rows of
    ``h`` neurons: ``rows`` x ``cols`` outputs a block, at least one warp
    of ``THREAD_TILE`` outputs a thread.  The grid stages W's column tile
    once per row tile and the trains once per column tile; per four k a
    warp reads four float2s of W (two wavefronts where its lanes span 64
    neurons) and a float4 of each train of its rows."""
    kp = -(-h // 4) * 4
    plans = []
    for rows in ROWS:
        row_tiles = -(-b // rows)
        for cols in COLS:
            if rows * cols < 32 * THREAD_TILE:
                continue
            col_tiles = -(-h // cols)
            blocks = row_tiles * col_tiles
            warps = -(-rows * cols // (32 * THREAD_TILE))
            w_fronts = 2 if cols == 64 else 1
            plans.append(_build.TilePlan(
                rows, cols, blocks, shared_bytes(ts, rows, cols, h),
                4 * (blocks * h * cols + col_tiles * ts * b * h),
                blocks * warps * kp // 4 * (4 * w_fronts + ts)))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, b: int, h: int) -> _build.TilePlan:
    """K1's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(ts, b, h))


def rsnn_cell(stim_base: torch.Tensor, s_prev: torch.Tensor, w: torch.Tensor,
              u0: torch.Tensor, h0: torch.Tensor, beta: torch.Tensor,
              vth: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on CUDA tensors.  stim_base/s_prev (TS, B, H) — stim_base
    may be a broadcast view (stride 0 over TS; its strides are passed, the
    view is never read as dense); w (H, H); u0/h0 (B, H); beta/vth (H,).
    Returns (spikes (TS, B, H), u (B, H)), float32."""
    global launches
    f32 = torch.float32
    dev = _build.cuda_device(
        "rsnn_cell", dict.fromkeys(("stim_base", "s_prev", "w", "u0", "h0",
                                    "beta", "vth"), f32),
        stim_base=stim_base, s_prev=s_prev, w=w, u0=u0, h0=h0, beta=beta,
        vth=vth)
    ts, b, h = s_prev.shape
    if stim_base.shape != (ts, b, h) or w.shape != (h, h) \
            or u0.shape != (b, h) or h0.shape != (b, h) \
            or beta.numel() != h or vth.numel() != h:
        raise ValueError(
            f"rsnn_cell: shapes stim_base {tuple(stim_base.shape)}, s_prev "
            f"{tuple(s_prev.shape)}, w {tuple(w.shape)}, u0 "
            f"{tuple(u0.shape)}, h0 {tuple(h0.shape)}, beta "
            f"{tuple(beta.shape)}, vth {tuple(vth.shape)} do not agree")
    if stim_base.stride(2) != 1:
        stim_base = stim_base.contiguous()
    s_prev, w, u0, h0 = (t.contiguous() for t in (s_prev, w, u0, h0))
    beta, vth = beta.reshape(h).contiguous(), vth.reshape(h).contiguous()
    spikes = torch.empty((ts, b, h), dtype=f32, device=dev)
    u = torch.empty((b, h), dtype=f32, device=dev)
    if spikes.numel() == 0:
        return spikes, u0.clone()
    plan = tile_plan(ts, b, h)
    fn = _build.function("rsnn_cell_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(stim_base.data_ptr(), stim_base.stride(0),
                    stim_base.stride(1), s_prev.data_ptr(), w.data_ptr(),
                    u0.data_ptr(), h0.data_ptr(), beta.data_ptr(),
                    vth.data_ptr(), spikes.data_ptr(), u.data_ptr(), ts, b, h,
                    plan.rows, plan.cols, _build.stream(dev))
    _build.check(status, "rsnn_cell")
    launches += 1
    return spikes, u
