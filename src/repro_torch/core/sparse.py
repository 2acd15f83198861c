"""The deployable compressed model: packed weights + inference LIF constants.

Re-exports the layout tensor types and their helpers so call sites keep
one import surface, as in the reference.  The packer (``pack_model``) and
the size report are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.layouts.csc import SparseColumns, sparse_matmul
from repro_torch.core.layouts.dense import QuantTensor, dequantize

__all__ = ["QuantTensor", "SparseColumns", "PackedRSNN", "dequantize",
           "sparse_matmul"]


class PackedRSNN(NamedTuple):
    """Deployable compressed model.

    ``sparse`` maps each mask-pruned weight to its layout-resolved packed
    tensor; consumers dispatch on the tensor's type via
    ``layouts.layout_of``.
    """

    quant: dict  # name -> QuantTensor (every quantized 2-D weight)
    sparse: dict  # name -> layout tensor (pruned weights)
    lif: dict  # {beta0, vth0, beta1, vth1}: (H,) float32
