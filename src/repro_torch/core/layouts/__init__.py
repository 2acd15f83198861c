"""Pluggable packed-weight layouts (see ``base.WeightLayout``).

Importing this package registers the ported layouts: ``dense``
(nibble-packed int4, ``dense.QuantTensor``), ``csc`` (padded
column-compressed sparse, ``csc.SparseColumns``) and ``nm_group``
(fixed-nnz-per-group N:M storage, ``nm.NMGroupPacked``).

``resolve_for_spec`` maps a tensor's ``PruneSpec`` to the layout that
stores it: an explicit ``spec.layout`` wins, ``"auto"`` picks ``nm_group``
for N:M specs that fit its nibble offsets and ``csc`` otherwise.
"""

from __future__ import annotations

from repro_torch.core.layouts import csc, dense, nm  # noqa: F401 (register)
from repro_torch.core.layouts.base import (WeightLayout, available_layouts,
                                           get_layout, layout_of,
                                           register_layout, unregister_layout)

__all__ = [
    "WeightLayout", "available_layouts", "get_layout", "layout_of",
    "register_layout", "unregister_layout", "resolve_for_spec", "csc",
    "dense", "nm",
]


def resolve_for_spec(spec) -> WeightLayout:
    """The sparse layout storing a masked tensor with PruneSpec ``spec``."""
    choice = getattr(spec, "layout", "auto") if spec is not None else "auto"
    if choice == "auto":
        if spec is not None and spec.kind == "nm" and spec.m <= 16:
            return get_layout("nm_group")
        return get_layout("csc")
    layout = get_layout(choice)
    if layout.name == "nm_group" and (spec is None or spec.kind != "nm"):
        raise ValueError(
            "layout 'nm_group' needs an N:M prune spec (kind='nm'); "
            f"got {spec!r}")
    return layout
