"""K5 wrapper: zero-skip FC readout over the group-packed N:M layout
(``csrc/nm_fc.cu``).

Replaces ``src/repro/kernels/nm_fc.py`` ``nm_fc`` (its ``pl.pallas_call``
at line 77).  The plain version is ``ref.nm_fc_ref``; they agree bit for
bit, and with K4 over the same mask stored as padded CSC.  The kernel
refuses an N:M geometry it cannot take (status ``kErrNmGeometry``);
``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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
    fn = _build.function("nm_fc_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(spikes_ts.data_ptr(), packed.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), ts, b, h, entries,
                    cols, int(n), int(m), _build.stream(dev))
    _build.check(status, "nm_fc")
    launches += 1
    return out
