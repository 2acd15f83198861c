"""Dense int4 layout: nibble-packed weights + per-channel scales.

The paper's baseline storage (Fig. 12): every weight at 4 bits, zero index
overhead.  ``kernels/int4_matmul.py``, ``kernels/merged_spike_fc.py`` and
``kernels/megastep.py`` read this layout directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.compression.quantization import pack_int4, unpack_int4
from repro_torch.core.layouts import base


class QuantTensor(NamedTuple):
    """Nibble-packed int4 weight matrix with per-output-channel scales."""

    packed: torch.Tensor  # (K//2, N) int8: low nibble = even row
    scale: torch.Tensor  # (1, N) float32


def dequantize(qt: QuantTensor) -> torch.Tensor:
    """(K, N) float32 dense weights: the int4 values times their scale."""
    return unpack_int4(qt.packed).to(torch.float32) * qt.scale


class DenseInt4Layout(base.WeightLayout):
    """Dense nibble-packed int4 (no sparsity exploited in storage)."""

    name = "dense"
    tensor_type = QuantTensor

    def pack(self, q, scale, *, keep=None, spec=None) -> QuantTensor:
        # ``keep`` was already applied to q by the caller's masking; dense
        # storage keeps the zeros in place
        return QuantTensor(packed=pack_int4(q), scale=scale.reshape(1, -1))

    def unpack(self, t: QuantTensor, k_rows: int) -> torch.Tensor:
        return dequantize(t)

    def matmul(self, x, t: QuantTensor) -> torch.Tensor:
        return x.to(torch.float32) @ dequantize(t)

    def fc_kernel(self, spikes_ts, t: QuantTensor) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels sit above

        return ops.merged_spike_fc(spikes_ts, t.packed, t.scale.reshape(-1))

    def megastep_fc(self, t: QuantTensor) -> tuple[str, tuple, dict]:
        return "dense_int4", (t.packed, t.scale), {}

    def stored_entries(self, t: QuantTensor) -> float:
        return float(t.packed.shape[0] * 2 * t.packed.shape[1])

    def size_bytes(self, t: QuantTensor, k_rows: int, bits: int = 4) -> float:
        return k_rows * t.packed.shape[1] * bits / 8.0

    def flatten(self, t: QuantTensor) -> dict:
        return {"packed": base.host(t.packed), "scale": base.host(t.scale)}

    def unflatten(self, fields) -> QuantTensor:
        return QuantTensor(**fields)


DENSE = base.register_layout(DenseInt4Layout())
