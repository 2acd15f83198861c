"""Pluggable packed-weight layouts (see ``base.WeightLayout``).

Importing this package registers the ported layouts: ``dense``
(nibble-packed int4, ``dense.QuantTensor``), ``csc`` (padded
column-compressed sparse, ``csc.SparseColumns``) and ``nm_group``
(fixed-nnz-per-group N:M storage, ``nm.NMGroupPacked``).
"""

from __future__ import annotations

from repro_torch.core.layouts import csc, dense, nm  # noqa: F401 (register)
from repro_torch.core.layouts.base import (WeightLayout, available_layouts,
                                           get_layout, layout_of,
                                           register_layout)

__all__ = [
    "WeightLayout", "available_layouts", "get_layout", "layout_of",
    "register_layout", "csc", "dense", "nm",
]
