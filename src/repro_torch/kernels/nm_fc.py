"""K5 wrapper: zero-skip FC readout over the group-packed N:M layout
(``csrc/nm_fc.cu``).

Replaces ``src/repro/kernels/nm_fc.py`` ``nm_fc`` (its ``pl.pallas_call``
at line 77).  The plain version is ``ref.nm_fc_ref``; they agree bit for
bit, and with K4 over the same mask stored as padded CSC.  The kernel
refuses an N:M geometry it cannot take (status ``kErrNmGeometry``);
``launches`` counts the kernel launches of this process; ``tile_plan``
chooses the kernel's tiles for each shape.

The kernel is K4's (``sparse_fc``) over one byte an entry: a block stages
its columns' packed tile with ``cp.async``, decodes it once into K4's
(offset, value) form and runs K4's gather loop (``csrc/common.cuh``
``gather_tile``), lanes on batch rows.  Bytes bound a call on the H100
(2.36 MB at B = 256, 2:4, N = 1920: 0.70 us).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def tile_plans(ts: int, b: int, h: int, entries: int,
               n: int) -> list[_build.TilePlan]:
    """Every tile plan K5's launch takes for ``ts`` trains of ``b`` rows of
    ``h`` and an (entries, n) packed N:M FC: ``rows`` (32 or 64) rows by
    ``cols`` (32, 64 or 128) columns a block, K4's tiles.  A block stages
    its columns' packed tile (entries x cols bytes), decodes it into an
    offset and a value tile (entries x cols each, 4 bytes an element) and
    stages its rows' merged spikes transposed with one pad column
    (h x (rows + 1) float32), as ``NmTileLayout`` computes them; the grid
    stages the packed FC once per row tile and the spikes once per column
    tile, and per entry of four columns a warp reads the (offset, value)
    quads and rows / 32 gathers a column."""
    plans = []
    for rows in (64, 32):
        row_tiles = -(-b // rows)
        for cols in (128, 64, 32):
            col_tiles = -(-n // cols)
            plans.append(_build.TilePlan(
                rows, cols, row_tiles * col_tiles,
                9 * entries * cols + 4 * h * (rows + 1),
                row_tiles * entries * col_tiles * cols
                + 4 * col_tiles * ts * b * h,
                row_tiles * col_tiles * cols // 4 * entries
                * (2 + rows // 8)))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, b: int, h: int, entries: int,
              n: int) -> _build.TilePlan:
    """K5's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(ts, b, h, entries, n))


def nm_fc(spikes_ts: torch.Tensor, packed: torch.Tensor,
          scale: torch.Tensor, *, n: int, m: int) -> torch.Tensor:
    """Launch K5 on CUDA tensors: spikes_ts (TS, B, H) (or pre-merged
    (B, H)) float32, packed (E, N) int8 (value | offset << 4, ``n`` entries
    of every ``m`` rows), scale (N,) or (1, N) float32.  Returns (B, N)
    float32."""
    global launches
    dev = _build.cuda_device(
        "nm_fc", {"spikes_ts": torch.float32, "packed": torch.int8,
                  "scale": torch.float32},
        spikes_ts=spikes_ts, packed=packed, scale=scale)
    if spikes_ts.dim() == 2:
        spikes_ts = spikes_ts.unsqueeze(0)
    ts, b, h = spikes_ts.shape
    entries, cols = packed.shape
    if scale.numel() != cols:
        raise ValueError(f"nm_fc: packed {tuple(packed.shape)} and scale "
                         f"{tuple(scale.shape)} do not agree")
    spikes_ts, packed = spikes_ts.contiguous(), packed.contiguous()
    scale = scale.reshape(cols).contiguous()
    out = torch.empty((b, cols), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(ts, b, h, entries, cols)
    fn = _build.function("nm_fc_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(spikes_ts.data_ptr(), packed.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), ts, b, h, entries,
                    cols, int(n), int(m), plan.rows, plan.cols,
                    _build.stream(dev))
    _build.check(status, "nm_fc")
    launches += 1
    return out
