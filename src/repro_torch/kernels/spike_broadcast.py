"""K9 and K10 wrappers: event-driven spike-broadcast matmul
(``csrc/spike_broadcast.cu``) and the recurrent cell over it
(``csrc/spike_cell.cu``).

Replace ``src/repro/kernels/spike_broadcast.py`` ``spike_broadcast`` (its
``pl.pallas_call`` at line 132) and ``spike_cell`` (line 183).  The plain
versions are ``ref.spike_broadcast_ref`` and ``ref.spike_cell_ref``; they
agree within the tolerance stated in ``chip_smoke.py`` and the tests (a
float32 sum of dequantized weights, in event order here).  The event
lists follow ``ref.compact_spikes``: ascending index, the first
``capacity`` nonzeros of a row kept (``None``: all K).  ``launches``
counts K9's launches of this process, ``cell_launches`` K10's.
``tile_plan`` chooses K9's tiles for each shape, ``cell_tile_plan``
K10's.

K10 is K1's block (``rsnn_cell``) with K9's union event lists: a block
stages its rows' trains and W's column tile into shared memory with
``cp.async``; each warp compacts the TS steps of its group's rows into one
union list (``GROUP`` lists a union) and runs it against the staged W, one
W read for every step; the LIF chain runs in the epilogue.  Each output's
sum is one ``fmaf`` chain in ascending index, so at lossless capacity on
0/1 trains K10 gives K1's bits.  Bytes bound a call on the H100 (about
1.1 MB at B = 256, H = 128, TS = 2: 0.33 us); the launch and one round of
staging set its time (PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

GROUP = 4  # lists that share one union event list (kUnionLists): K9's rows
CELL_ROWS = (1, 2, 4, 8, 16, 32)  # K10: batch rows a block
CELL_COLS = (32, 64, 128)  # K10: neurons a block, 32 lanes x 1, 2 or 4
CELL_MAX_WARPS = 8  # K10: warps a block, one per group of lists
launches = 0  # K9 spike_broadcast
cell_launches = 0  # K10 spike_cell

_SB_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_CELL_ARGS = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
              + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
              + [ctypes.c_void_p])


def event_capacity(capacity: int | None, k: int) -> int:
    """Event-list slots per row: ``k`` (lossless) for ``None``, else
    ``min(capacity, k)``; a capacity below 1 raises."""
    if capacity is None:
        return k
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    return min(capacity, k)


def tile_plans(ts: int, r: int, k: int, n: int) -> list[_build.TilePlan]:
    """Every tile plan K9's launch takes for ``ts`` trains of ``r`` rows of
    ``k`` by a (k, n) W, at any event capacity: ``rows`` (a multiple of
    ``GROUP``: each group of rows shares one union event list) by ``cols``
    (32, 64 or 128) columns a block.  A block stages its W column tile
    (k x cols float32) and per group a union list of up to k entries
    (padded to a multiple of 4), each an offset and ``GROUP`` values, and
    the lists' lengths, as ``spike_broadcast_launch`` computes them.  The
    grid stages W once per row tile and compacts the rows once per column
    tile; per union entry (at most k) a warp reads cols / 32 wavefronts of
    W, GROUP / 4 of values and a quarter of an offset quad."""
    slots = -(-k // 4) * 4
    plans = []
    for cols in (128, 64, 32):
        col_tiles = -(-n // cols)
        for rows in (64, 32, 16, 8, 4):
            if rows % GROUP:
                continue
            row_tiles = -(-r // rows)
            groups = rows // GROUP
            entry_quarters = 4 * (cols // 32 + GROUP // 4) + 1
            plans.append(_build.TilePlan(
                rows, cols, row_tiles * col_tiles,
                4 * k * cols + (4 * GROUP + 4) * groups * slots + 4 * groups,
                4 * k * (row_tiles * col_tiles * cols + col_tiles * r * ts),
                -(-r // GROUP) * col_tiles * k * entry_quarters // 4))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, r: int, k: int, n: int) -> _build.TilePlan:
    """K9's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(ts, r, k, n))


def group_rows(ts: int) -> int:
    """K10's rows a union group: its ``GROUP`` lists are the ``ts`` steps
    of each row (TS = 3: one row, the fourth list empty)."""
    return 1 if ts >= 3 else GROUP // ts


def cell_shared_bytes(ts: int, rows: int, cols: int, h: int) -> int:
    """A K10 block's shared memory as ``CellLayout`` computes it: W's
    column tile, and per group a union of up to H entries (k padded to 4),
    each a float4 of values and an offset, and the rows' ``ts`` trains."""
    kp = -(-h // 4) * 4
    groups = -(-rows // group_rows(ts))
    return 4 * h * cols + 20 * groups * kp + 4 * rows * ts * kp


def cell_tile_plans(ts: int, b: int, h: int) -> list[_build.TilePlan]:
    """Every tile plan K10's launch takes for ``ts`` trains of ``b`` rows
    of ``h`` neurons: ``rows`` (whole groups of ``group_rows(ts)``, at
    most ``CELL_MAX_WARPS`` groups) by ``cols`` neurons a block.  The grid
    stages W's column tile once per row tile and the trains once per
    column tile; per union entry (at most h) a warp reads cols / 32
    wavefronts of W, one of values and a quarter of an offset quad."""
    gr = group_rows(ts)
    kp = -(-h // 4) * 4
    plans = []
    for rows in CELL_ROWS:
        if rows % gr or rows // gr > CELL_MAX_WARPS:
            continue
        row_tiles = -(-b // rows)
        for cols in CELL_COLS:
            col_tiles = -(-h // cols)
            blocks = row_tiles * col_tiles
            plans.append(_build.TilePlan(
                rows, cols, blocks, cell_shared_bytes(ts, rows, cols, h),
                4 * (blocks * h * cols + col_tiles * ts * b * h),
                blocks * (rows // gr) * kp * (4 * (cols // 32) + 5) // 4))
    return plans


@functools.lru_cache(maxsize=256)
def cell_tile_plan(ts: int, b: int, h: int) -> _build.TilePlan:
    """K10's tiles for this shape: ``_build.pick_tiles`` of
    ``cell_tile_plans``."""
    return _build.pick_tiles(cell_tile_plans(ts, b, h))


def spike_broadcast(x: torch.Tensor, w: torch.Tensor, *,
                    capacity: int | None = None) -> torch.Tensor:
    """Launch K9 on CUDA tensors: ``x`` (R, K), or (TS, B, K) spike trains
    merged over TS first; ``w`` (K, N), float32.  Returns (R|B, N)
    float32."""
    global launches
    dev = _build.cuda_device("spike_broadcast", {"x": torch.float32,
                                                 "w": torch.float32},
                             x=x, w=w)
    x3 = x.unsqueeze(0) if x.dim() == 2 else x
    if x3.dim() != 3 or w.dim() != 2 or x3.shape[2] != w.shape[0]:
        raise ValueError(f"spike_broadcast: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not agree")
    ts, r, k = x3.shape
    n = w.shape[1]
    cap = event_capacity(capacity, k)
    x3, w = x3.contiguous(), w.contiguous()
    out = torch.empty((r, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(ts, r, k, n)
    fn = _build.function("spike_broadcast_launch", _SB_ARGS)
    with torch.cuda.device(dev):
        status = fn(x3.data_ptr(), w.data_ptr(), out.data_ptr(), ts, r, k, n,
                    cap, plan.rows, plan.cols, _build.stream(dev))
    _build.check(status, "spike_broadcast")
    launches += 1
    return out


def spike_cell(stim_base: torch.Tensor, s_prev: torch.Tensor, w: torch.Tensor,
               u0: torch.Tensor, h0: torch.Tensor, beta: torch.Tensor,
               vth: torch.Tensor, *, capacity: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K10 on CUDA tensors, K1's arguments (``stim_base`` may be a
    broadcast view: its strides are passed, it is never read as dense)
    plus the event-list ``capacity``.  Returns (spikes (TS, B, H), u
    (B, H)), float32."""
    global cell_launches
    f32 = torch.float32
    dev = _build.cuda_device(
        "spike_cell", dict.fromkeys(("stim_base", "s_prev", "w", "u0", "h0",
                                     "beta", "vth"), f32),
        stim_base=stim_base, s_prev=s_prev, w=w, u0=u0, h0=h0, beta=beta,
        vth=vth)
    ts, b, h = s_prev.shape
    if stim_base.shape != (ts, b, h) or w.shape != (h, h) \
            or u0.shape != (b, h) or h0.shape != (b, h) \
            or beta.numel() != h or vth.numel() != h:
        raise ValueError(
            f"spike_cell: shapes stim_base {tuple(stim_base.shape)}, s_prev "
            f"{tuple(s_prev.shape)}, w {tuple(w.shape)}, u0 "
            f"{tuple(u0.shape)}, h0 {tuple(h0.shape)}, beta "
            f"{tuple(beta.shape)}, vth {tuple(vth.shape)} do not agree")
    cap = event_capacity(capacity, h)
    if stim_base.stride(2) != 1:
        stim_base = stim_base.contiguous()
    s_prev, w, u0, h0 = (t.contiguous() for t in (s_prev, w, u0, h0))
    beta, vth = beta.reshape(h).contiguous(), vth.reshape(h).contiguous()
    spikes = torch.empty((ts, b, h), dtype=f32, device=dev)
    u = torch.empty((b, h), dtype=f32, device=dev)
    if spikes.numel() == 0:
        return spikes, u0.clone()
    plan = cell_tile_plan(ts, b, h)
    fn = _build.function("spike_cell_launch", _CELL_ARGS)
    with torch.cuda.device(dev):
        status = fn(stim_base.data_ptr(), stim_base.stride(0),
                    stim_base.stride(1), s_prev.data_ptr(), w.data_ptr(),
                    u0.data_ptr(), h0.data_ptr(), beta.data_ptr(),
                    vth.data_ptr(), spikes.data_ptr(), u.data_ptr(), ts, b, h,
                    cap, plan.rows, plan.cols, _build.stream(dev))
    _build.check(status, "spike_cell")
    cell_launches += 1
    return spikes, u
