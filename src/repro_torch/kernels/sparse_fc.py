"""K4 wrapper: zero-skip FC readout over padded CSC (``csrc/sparse_fc.cu``).

Replaces ``src/repro/kernels/sparse_fc.py`` ``sparse_fc`` (its
``pl.pallas_call`` at line 69).  The plain version is
``ref.sparse_fc_ref``; they agree bit for bit.  Unlike the TPU kernel
there is no block that must divide N or B: the kernel masks the ragged
edge.  ``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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
    fn = _build.function("sparse_fc_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(spikes_ts.data_ptr(), indices.data_ptr(),
                    values.data_ptr(), scale.data_ptr(), out.data_ptr(), ts,
                    b, h, nnz, n, _build.stream(dev))
    _build.check(status, "sparse_fc")
    launches += 1
    return out
