"""Padded-CSC layout: zero-skipping storage for unstructured sparsity.

For every output channel the surviving row indices and int4 values, padded
to the densest column.  ``kernels/sparse_fc.py`` and
``kernels/megastep.py`` read this layout.
"""

from __future__ import annotations

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


def sparse_matmul(x: torch.Tensor, sc: SparseColumns) -> torch.Tensor:
    """Zero-skipping matmul oracle: x (B, K) @ CSC -> (B, N) float32.

    Gathers ``x[:, indices]`` into a (B, nnz_max, N) intermediate, then
    sums over the nnz axis and scales once per channel.
    """
    xg = x.to(torch.float32)[:, sc.indices.long()]  # (B, nnz_max, N)
    acc = (xg * sc.values).sum(dim=1)
    return acc * sc.scale


class SparseColumnsLayout(base.WeightLayout):
    """Padded CSC over any unstructured pruning mask."""

    name = "csc"
    tensor_type = SparseColumns

    def matmul(self, x, t: SparseColumns) -> torch.Tensor:
        return sparse_matmul(x, t)

    def fc_kernel(self, spikes_ts, t: SparseColumns) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels sit above

        return ops.sparse_fc(spikes_ts, t.indices, t.values, t.scale)

    def megastep_fc(self, t: SparseColumns) -> tuple[str, tuple, dict]:
        return "csc", (t.indices, t.values, t.scale), {}

    def unflatten(self, fields) -> SparseColumns:
        return SparseColumns(**fields)


CSC = base.register_layout(SparseColumnsLayout())
