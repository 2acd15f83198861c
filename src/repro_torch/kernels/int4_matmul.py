"""K2 wrapper: matmul against nibble-packed int4 weights
(``csrc/int4_matmul.cu``).

Replaces ``src/repro/kernels/int4_matmul.py`` ``int4_matmul`` (its
``pl.pallas_call`` at line 65).  The plain version is
``ref.int4_matmul_ref``; on integer-valued inputs the two agree bit for
bit.  ``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    fn = _build.function("int4_matmul_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), m, k, n, _build.stream(dev))
    _build.check(status, "int4_matmul")
    launches += 1
    return out
