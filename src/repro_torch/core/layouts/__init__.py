"""Pluggable packed-weight layouts (see ``base.WeightLayout``).

Importing this package registers the ported layouts: ``dense``
(nibble-packed int4, ``dense.QuantTensor``) and ``csc`` (padded
column-compressed sparse, ``csc.SparseColumns``).  The group-packed
``nm_group`` layout is not ported yet; ``core/artifact.py`` refuses it.
"""

from __future__ import annotations

from repro_torch.core.layouts import csc, dense  # noqa: F401 (register)
from repro_torch.core.layouts.base import (WeightLayout, available_layouts,
                                           get_layout, layout_of,
                                           register_layout)

__all__ = [
    "WeightLayout", "available_layouts", "get_layout", "layout_of",
    "register_layout", "csc", "dense",
]
