"""K8 wrapper: delta-temporal input gating (``csrc/delta_step.cu``).

Replaces ``src/repro/kernels/delta_step.py`` ``delta_step`` (its
``pl.pallas_call`` at line 57).  The plain version is
``ref.delta_step_ref``: ``mask``, ``x_hat`` and the cached ``pre`` rows
agree bit for bit, the recomputed rows within the tolerance stated in
``chip_smoke.py`` and the tests (a float32 sum of dequantized weights).
Unlike the TPU kernel there is no batch block that must divide B.
``launches`` counts the kernel launches of this process; ``tile_plan``
chooses the kernel's tiles for each shape.

A block owns ``rows`` x ``cols`` outputs: it stages W's column tile into
shared memory with ``cp.async``, gates its rows (one warp a row) into
shared memory with a changed flag each, and gives each thread ``VEC``
adjacent outputs of one row: an ascending ``fmaf`` chain over D for a
changed row, ``pre_prev``'s values (one vector load) for a held one.
Bytes bound a call on the H100 (about 0.32 MB at B = 256, D = 40,
H = 128: 0.1 us); the launch and one round of loads set its time
(PERF.md).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 5 + [ctypes.c_void_p])

ROWS = (1, 2, 4, 8, 16, 32)  # batch rows a block
# outputs of a row a block: at least 32, so that a warp spans at most four
# rows (16 columns gated each row once per 16 outputs and were the slowest
# plans of their row count on the H100: PERF.md)
COLS = (32, 64, 128)
VEC = 4  # adjacent outputs a thread (kVec)


def shared_bytes(rows: int, cols: int, d: int) -> int:
    """A block's shared memory as ``DeltaLayout`` computes it: W's column
    tile, the rows' x_hat and a changed flag a row."""
    return 4 * (d * cols + rows * d + rows)


def tile_plans(b: int, d: int, h: int) -> list[_build.TilePlan]:
    """Every tile plan K8's launch takes for ``b`` rows of ``d`` inputs and
    ``h`` outputs: ``rows`` x ``cols`` outputs a block, one to 32 warps of
    ``VEC`` outputs a thread.  The grid stages W's column tile once per row
    tile and reads x and x_prev once per column tile; per k a warp reads
    its float4s of W (cols / 32 wavefronts, at least one) and one of
    x_hat."""
    plans = []
    for rows in ROWS:
        row_tiles = -(-b // rows)
        for cols in COLS:
            threads = rows * cols // VEC
            if not 32 <= threads <= 1024:
                continue
            col_tiles = -(-h // cols)
            blocks = row_tiles * col_tiles
            plans.append(_build.TilePlan(
                rows, cols, blocks, shared_bytes(rows, cols, d),
                4 * (blocks * d * cols + col_tiles * 2 * b * d),
                blocks * (threads // 32) * d * (max(1, cols // 32) + 1)))
    return plans


@functools.lru_cache(maxsize=256)
def tile_plan(b: int, d: int, h: int) -> _build.TilePlan:
    """K8's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(b, d, h))


def delta_step(x: torch.Tensor, x_prev: torch.Tensor, pre_prev: torch.Tensor,
               w: torch.Tensor, threshold: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K8 on CUDA tensors: x/x_prev (B, D), pre_prev (B, H), w
    (D, H) float32, ``threshold`` a Python float.  Returns (x_hat (B, D),
    pre (B, H), mask (B, D) float {0, 1}), float32."""
    global launches
    dev = _build.cuda_device(
        "delta_step", dict.fromkeys(("x", "x_prev", "pre_prev", "w"),
                                    torch.float32),
        x=x, x_prev=x_prev, pre_prev=pre_prev, w=w)
    b, d = x.shape
    h = w.shape[1]
    if x_prev.shape != (b, d) or pre_prev.shape != (b, h) \
            or w.shape != (d, h):
        raise ValueError(f"delta_step: shapes x {tuple(x.shape)}, x_prev "
                         f"{tuple(x_prev.shape)}, pre_prev "
                         f"{tuple(pre_prev.shape)}, w {tuple(w.shape)} do "
                         f"not agree")
    x, x_prev, pre_prev, w = (t.contiguous() for t in (x, x_prev, pre_prev, w))
    x_hat = torch.empty((b, d), dtype=torch.float32, device=dev)
    pre = torch.empty((b, h), dtype=torch.float32, device=dev)
    mask = torch.empty((b, d), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return x_hat, pre, mask
    plan = tile_plan(b, d, h)
    fn = _build.function("delta_step_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), x_prev.data_ptr(), pre_prev.data_ptr(),
                    w.data_ptr(), float(threshold), x_hat.data_ptr(),
                    pre.data_ptr(), mask.data_ptr(), b, d, h, plan.rows,
                    plan.cols, _build.stream(dev))
    _build.check(status, "delta_step")
    launches += 1
    return x_hat, pre, mask
