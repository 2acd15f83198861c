"""Quantization-aware training + int4 packing (paper §II-D3).

Weights are quantized to a symmetric fixed-point grid (4-bit in the paper)
with per-tensor or per-channel scales; ``fake_quant`` passes the gradient
straight through.  ``pack_int4``/``unpack_int4`` hold two int4 values per
byte along the leading axis: the low nibble is even row ``2i``, the high
nibble row ``2i+1``, each sign-extended from [0, 15] to [-8, 7] — the
layout the int4 kernels read.

Everything runs in torch on the device of the tensors given.  Every
division is a float32 division by a tensor: PyTorch divides a CUDA tensor
by a Python scalar as a product with its reciprocal, which can round an
ulp away from the reference's ``w / scale``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    bits: int = 4
    granularity: Literal["per_tensor", "per_channel"] = "per_channel"
    # membrane/accumulator width of the paper's (m, n) sweep: 12 bits
    accum_bits: int = 12


def _qmax(spec: QuantSpec) -> float:
    return 2.0 ** (spec.bits - 1) - 1


def _scale_for(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """max |w| over each output channel (or the tensor), floored at 1e-8,
    over qmax."""
    if spec.granularity == "per_channel":
        amax = w.abs().amax(dim=0, keepdim=True)
    else:
        amax = w.abs().amax()
    qmax = torch.full((), _qmax(spec), dtype=w.dtype, device=w.device)
    return torch.clamp(amax, min=1e-8) / qmax


def _grid(w: torch.Tensor, scale: torch.Tensor,
          spec: QuantSpec) -> torch.Tensor:
    """round(w / scale), half to even, clipped to [-qmax - 1, qmax]."""
    qmax = _qmax(spec)
    return torch.clamp(torch.round(w / scale), -qmax - 1, qmax)


def fake_quant(w: torch.Tensor, spec: QuantSpec = QuantSpec()
               ) -> torch.Tensor:
    """Symmetric fake-quant with a straight-through gradient."""
    scale = _scale_for(w.detach(), spec)
    q = _grid(w.detach(), scale, spec) * scale
    return w + (q - w).detach()


def quantize_tree(params: dict, spec: QuantSpec,
                  names: tuple[str, ...]) -> dict:
    out = dict(params)
    for n in names:
        out[n] = fake_quant(params[n], spec)
    return out


def quantize_to_int(w: torch.Tensor, spec: QuantSpec = QuantSpec()
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer quantization for deployment: (q held in int8, scale)."""
    scale = _scale_for(w, spec)
    return _grid(w, scale, spec).to(torch.int8), scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(2k, n) int8 in [-8, 7] -> (k, n) int8, low nibble = even row."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_int4 packs row pairs; the leading dim is "
                         f"{q.shape[0]}")
    lo = q[0::2].to(torch.int16) & 0xF
    hi = (q[1::2].to(torch.int16) & 0xF) << 4
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(k, n) int8 nibble pairs -> (2k, n) int8 in [-8, 7]."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1)  # (k, 2, n)
    return out.reshape(packed.shape[0] * 2, *packed.shape[1:]).to(torch.int8)
