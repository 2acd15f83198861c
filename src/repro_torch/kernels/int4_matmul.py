"""K2 wrapper: matmul against nibble-packed int4 weights
(``csrc/int4_matmul.cu``).

Replaces ``src/repro/kernels/int4_matmul.py`` ``int4_matmul`` (its
``pl.pallas_call`` at line 65).  The plain version is
``ref.int4_matmul_ref``; on inputs that are integers in [-128, 127] the
kernel runs on the int8 tensor cores and the two agree bit for bit; on
other float inputs a block runs a float32 chain and they agree within
float32 rounding.  ``launches`` counts the kernel launches of this
process; ``tile_plan`` chooses the kernel's tiles for each shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

ROWS = (16, 32, 64)  # rows a block int4_tile_kernel takes
COLS = (8, 16, 32, 64, 128)  # columns a block
MMA_K = 32  # depth of one mma step (kMmaK); K is padded to a multiple of it
TILE_PAD = 16  # bytes after each int8 row in shared memory (kTilePad)


def shared_bytes(ts: int, rows: int, cols: int, k: int) -> int:
    """A block's shared memory as ``Int4TileLayout`` computes it: the
    staged float32 trains, the int8 rows and unpacked columns (K padded to
    ``MMA_K``, each row ``TILE_PAD`` bytes longer) and the packed tile."""
    kp = -(-k // MMA_K) * MMA_K
    return (4 * max(ts, 1) * rows * kp + (rows + cols) * (kp + TILE_PAD)
            + k // 2 * cols)


def plans(ts: int, m: int, k: int, n: int) -> list[_build.TilePlan]:
    """Every tile plan of ``int4_tile_kernel`` (K2 at ``ts`` = 1, K3) for
    ``ts`` float32 trains of ``m`` rows of ``k`` and an int4 (k/2, n)
    weight: ``rows`` x ``cols`` outputs a block.  The grid stages the rows
    once per column tile (4 ts k bytes a row) and the packed weights once
    per row tile; for each 32-deep step a warp's 16 x 8 or 16 x 16 output
    tile reads 4 A fragment words a lane and 2 B words per n8 tile, one
    shared-memory wavefront each."""
    kp = -(-k // MMA_K) * MMA_K
    out = []
    for rows in ROWS:
        row_tiles = -(-m // rows)
        for cols in COLS:
            col_tiles = -(-n // cols)
            sub = 2 if cols >= 16 else 1
            out.append(_build.TilePlan(
                rows, cols, row_tiles * col_tiles,
                shared_bytes(ts, rows, cols, k),
                col_tiles * 4 * ts * m * k + row_tiles * k // 2 * n,
                row_tiles * col_tiles * (rows // 16) * (cols // (8 * sub))
                * (kp // MMA_K) * (4 + 2 * sub)))
    return out


def tile_plans(m: int, k: int, n: int) -> list[_build.TilePlan]:
    """Every tile plan K2's launch takes for x (m, k) and packed (k/2, n)."""
    return plans(1, m, k, n)


@functools.lru_cache(maxsize=256)
def tile_plan(m: int, k: int, n: int) -> _build.TilePlan:
    """K2's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(m, k, n))


def int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: x (M, K) float32, packed (K/2, N) int8,
    scale (N,) or (1, N) float32.  Returns (M, N) float32."""
    global launches
    dev = _build.cuda_device(
        "int4_matmul", {"x": torch.float32, "packed": torch.int8,
                        "scale": torch.float32},
        x=x, packed=packed, scale=scale)
    m, k = x.shape
    k2, n = packed.shape
    if k != 2 * k2 or scale.numel() != n:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scale {tuple(scale.shape)} "
                         f"do not agree")
    x, packed = x.contiguous(), packed.contiguous()
    scale = scale.reshape(n).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(m, k, n)
    fn = _build.function("int4_matmul_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), m, k, n, plan.rows, plan.cols,
                    _build.stream(dev))
    _build.check(status, "int4_matmul")
    launches += 1
    return out
