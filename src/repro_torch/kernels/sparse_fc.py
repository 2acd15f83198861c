"""K4 wrapper: zero-skip FC readout over padded CSC (``csrc/sparse_fc.cu``).

Replaces ``src/repro/kernels/sparse_fc.py`` ``sparse_fc`` (its
``pl.pallas_call`` at line 69).  The plain version is
``ref.sparse_fc_ref``; they agree bit for bit.  Unlike the TPU kernel
there is no block that must divide N or B: the kernel masks the ragged
edge.  ``launches`` counts the kernel launches of this process;
``tile_plan`` chooses the kernel's tiles for each shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def tile_plans(ts: int, b: int, h: int, nnz: int,
               n: int) -> list[_build.TilePlan]:
    """Every tile plan K4's launch takes for ``ts`` trains of ``b`` rows of
    ``h`` and an (nnz, n) padded CSC: ``rows`` (32 or 64) rows by ``cols``
    (32, 64 or 128) columns a block.  A block stages its columns' index and value tiles
    (nnz x cols each) and its rows' merged spikes, transposed with one
    pad column (h x (rows + 1) float32), as ``sparse_fc_launch`` computes
    them; the grid stages the CSC once per row tile and the spikes once per
    column tile, and per entry of four columns a warp reads the (index,
    value) quads and rows / 32 gathers a column."""
    plans = []
    for rows in (64, 32):
        row_tiles = -(-b // rows)
        for cols in (128, 64, 32):
            col_tiles = -(-n // cols)
            plans.append(_build.TilePlan(
                rows, cols, row_tiles * col_tiles,
                8 * nnz * cols + 4 * h * (rows + 1),
                8 * row_tiles * nnz * col_tiles * cols
                + 4 * col_tiles * ts * b * h,
                row_tiles * col_tiles * cols // 4 * nnz * (2 + rows // 8)))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, b: int, h: int, nnz: int, n: int) -> _build.TilePlan:
    """K4's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(ts, b, h, nnz, n))


def sparse_fc(spikes_ts: torch.Tensor, indices: torch.Tensor,
              values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors: spikes_ts (TS, B, H) (or pre-merged
    (B, H)) float32, indices (nnz_max, N) int32, values (nnz_max, N)
    float32, scale (N,) or (1, N) float32.  Returns (B, N) float32."""
    global launches
    dev = _build.cuda_device(
        "sparse_fc", {"spikes_ts": torch.float32, "indices": torch.int32,
                      "values": torch.float32, "scale": torch.float32},
        spikes_ts=spikes_ts, indices=indices, values=values, scale=scale)
    if spikes_ts.dim() == 2:
        spikes_ts = spikes_ts.unsqueeze(0)
    ts, b, h = spikes_ts.shape
    nnz, n = indices.shape
    if values.shape != indices.shape or scale.numel() != n:
        raise ValueError(f"sparse_fc: indices {tuple(indices.shape)}, values "
                         f"{tuple(values.shape)}, scale {tuple(scale.shape)} "
                         f"do not agree")
    spikes_ts, indices, values = (t.contiguous()
                                  for t in (spikes_ts, indices, values))
    scale = scale.reshape(n).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(ts, b, h, nnz, n)
    fn = _build.function("sparse_fc_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(spikes_ts.data_ptr(), indices.data_ptr(),
                    values.data_ptr(), scale.data_ptr(), out.data_ptr(), ts,
                    b, h, nnz, n, plan.rows, plan.cols, _build.stream(dev))
    _build.check(status, "sparse_fc")
    launches += 1
    return out
