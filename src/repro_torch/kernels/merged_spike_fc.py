"""K3 wrapper: merged-spike FC readout with int4 weights
(``csrc/merged_spike_fc.cu``).

Replaces ``src/repro/kernels/merged_spike_fc.py`` ``merged_spike_fc``
(its ``pl.pallas_call`` at line 43).  The plain version is
``ref.merged_spike_fc_ref``; on spikes they agree bit for bit (the
merged values are integers the int8 tensor cores take exactly; other float
inputs run a float32 chain, within float32 rounding).  The kernel is K2's
(``int4_matmul.plans``) over ``TS`` trains.  ``launches`` counts the
kernel launches of this process; ``tile_plan`` chooses the kernel's tiles
for each shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, int4_matmul

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def tile_plans(ts: int, b: int, h: int, n: int) -> list[_build.TilePlan]:
    """Every tile plan K3's launch takes for ``ts`` spike trains of ``b``
    rows of ``h`` and packed (h/2, n): ``int4_matmul.plans``."""
    return int4_matmul.plans(ts, b, h, n)


@functools.lru_cache(maxsize=256)
def tile_plan(ts: int, b: int, h: int, n: int) -> _build.TilePlan:
    """K3's tiles for this shape: ``_build.pick_tiles`` of ``tile_plans``."""
    return _build.pick_tiles(tile_plans(ts, b, h, n))


def merged_spike_fc(spikes_ts: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors: spikes_ts (TS, B, H) float32, packed
    (H/2, N) int8, scale (N,) or (1, N) float32.  Returns (B, N) float32
    logits summed over time steps."""
    global launches
    dev = _build.cuda_device(
        "merged_spike_fc", {"spikes_ts": torch.float32, "packed": torch.int8,
                            "scale": torch.float32},
        spikes_ts=spikes_ts, packed=packed, scale=scale)
    ts, b, h = spikes_ts.shape
    h2, n = packed.shape
    if h != 2 * h2 or scale.numel() != n:
        raise ValueError(f"merged_spike_fc: spikes {tuple(spikes_ts.shape)},"
                         f" packed {tuple(packed.shape)}, scale "
                         f"{tuple(scale.shape)} do not agree")
    spikes_ts, packed = spikes_ts.contiguous(), packed.contiguous()
    scale = scale.reshape(n).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(ts, b, h, n)
    fn = _build.function("merged_spike_fc_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(spikes_ts.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), ts, b, h, n, plan.rows, plan.cols,
                    _build.stream(dev))
    _build.check(status, "merged_spike_fc")
    launches += 1
    return out
