"""K8 wrapper: delta-temporal input gating (``csrc/delta_step.cu``).

Replaces ``src/repro/kernels/delta_step.py`` ``delta_step`` (its
``pl.pallas_call`` at line 57).  The plain version is
``ref.delta_step_ref``: ``mask``, ``x_hat`` and the cached ``pre`` rows
agree bit for bit, the recomputed rows within the tolerance stated in
``chip_smoke.py`` and the tests (a float32 sum of dequantized weights).
Unlike the TPU kernel there is no batch block that must divide B.
``launches`` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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
    fn = _build.function("delta_step_launch", _ARGS)
    with torch.cuda.device(dev):
        status = fn(x.data_ptr(), x_prev.data_ptr(), pre_prev.data_ptr(),
                    w.data_ptr(), float(threshold), x_hat.data_ptr(),
                    pre.data_ptr(), mask.data_ptr(), b, d, h,
                    _build.stream(dev))
    _build.check(status, "delta_step")
    launches += 1
    return x_hat, pre, mask
