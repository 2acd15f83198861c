"""Padded-CSC layout: zero-skipping storage for unstructured sparsity.

For every output channel the surviving row indices and int4 values, padded
to the densest column.  Index cost is ``ceil(log2 K)`` bits an entry plus
the padding to ``nnz_max``.  ``kernels/sparse_fc.py`` and
``kernels/megastep.py`` read this layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.layouts import base


class SparseColumns(NamedTuple):
    """Padded column-compressed sparse int4 matrix.

    ``indices[i, n]`` is the row of the i-th surviving weight of output
    channel ``n``; ``values[i, n]`` its int4 value held in float32.
    Columns shorter than the densest one are padded with (index 0,
    value 0), so padded entries contribute nothing and need no mask.
    ``count[n]`` is the number of stored entries of column ``n`` (size
    accounting only; ``None`` where the artifact has none).
    """

    indices: torch.Tensor  # (nnz_max, N) int32
    values: torch.Tensor  # (nnz_max, N) float32, integer-valued in [-8, 7]
    scale: torch.Tensor  # (1, N) float32
    count: torch.Tensor | None = None  # (N,) int32


def sparsify_columns(q: torch.Tensor, scale: torch.Tensor,
                     keep: torch.Tensor | None = None) -> SparseColumns:
    """The padded-CSC view of an int-quantized matrix, on ``q``'s device.

    q: (K, N) integer-valued.  ``keep`` is the pruning mask deciding which
    entries are stored (a kept weight that quantizes to 0 is stored with
    value 0); ``keep=None`` stores the nonzeros of ``q``.  Each column
    holds its kept rows first, in row order (a stable sort on "dropped"),
    then (index 0, value 0) pads up to the densest column.
    """
    kp = (q != 0) if keep is None else keep.to(torch.bool)
    nnz_max = max(int(kp.sum(dim=0).max()), 1)
    order = torch.argsort((~kp).to(torch.int8), dim=0, stable=True)[:nnz_max]
    taken = torch.gather(kp, 0, order)
    vals = torch.where(taken, torch.gather(q, 0, order), 0)
    idx = torch.where(taken, order, 0)
    return SparseColumns(
        indices=idx.to(torch.int32), values=vals.to(torch.float32),
        scale=scale.to(torch.float32).reshape(1, -1),
        count=kp.sum(dim=0).to(torch.int32))


def sparse_matmul(x: torch.Tensor, sc: SparseColumns) -> torch.Tensor:
    """Zero-skipping matmul oracle: x (B, K) @ CSC -> (B, N) float32.

    Gathers ``x[:, indices]`` into a (B, nnz_max, N) intermediate, then
    sums over the nnz axis and scales once per channel.
    """
    xg = x.to(torch.float32)[:, sc.indices.long()]  # (B, nnz_max, N)
    acc = (xg * sc.values).sum(dim=1)
    return acc * sc.scale


def csc_stored_entries(sc: SparseColumns) -> float:
    """Stored entries of a CSC layout: the mask-kept count when the tensor
    has one (the exact Fig. 12 accounting), else the nonzero values."""
    if sc.count is not None:
        return float(sc.count.sum())
    return float((sc.values != 0).sum())


def csc_size_bytes(sc: SparseColumns, k_rows: int, bits: int = 4) -> float:
    """CSC storage: value nibbles + ceil(log2 K)-bit row indices an entry."""
    index_bits = max(math.ceil(math.log2(max(k_rows, 2))), 1)
    return csc_stored_entries(sc) * (bits + index_bits) / 8.0


class SparseColumnsLayout(base.WeightLayout):
    """Padded CSC over any unstructured pruning mask."""

    name = "csc"
    tensor_type = SparseColumns

    def pack(self, q, scale, *, keep=None, spec=None) -> SparseColumns:
        return sparsify_columns(q, scale, keep=keep)

    def unpack(self, t: SparseColumns, k_rows: int) -> torch.Tensor:
        n = t.indices.shape[1]
        dense = torch.zeros((k_rows, n), dtype=torch.float32,
                            device=t.values.device)
        # scatter-add: pad entries carry value 0, so a pad landing on a
        # stored row (index 0) adds nothing
        dense.scatter_add_(0, t.indices.long(), t.values)
        return dense * t.scale

    def matmul(self, x, t: SparseColumns) -> torch.Tensor:
        return sparse_matmul(x, t)

    def fc_kernel(self, spikes_ts, t: SparseColumns) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels sit above

        return ops.sparse_fc(spikes_ts, t.indices, t.values, t.scale)

    def megastep_fc(self, t: SparseColumns) -> tuple[str, tuple, dict]:
        return "csc", (t.indices, t.values, t.scale), {}

    def stored_entries(self, t: SparseColumns) -> float:
        return csc_stored_entries(t)

    def size_bytes(self, t: SparseColumns, k_rows: int,
                   bits: int = 4) -> float:
        return csc_size_bytes(t, k_rows, bits)

    def flatten(self, t: SparseColumns) -> dict:
        flat = {"indices": base.host(t.indices),
                "values": base.host(t.values), "scale": base.host(t.scale)}
        if t.count is not None:
            flat["count"] = base.host(t.count)
        return flat

    def unflatten(self, fields) -> SparseColumns:
        return SparseColumns(**fields)


CSC = base.register_layout(SparseColumnsLayout())
