"""Group-packed N:M layout: fixed ``n`` survivors per ``m``-row group, no
index padding (serving side).

Every group of ``m`` consecutive input rows keeps ``n`` entries, so entry
``e`` of a column belongs to group ``e // n`` and only its in-group row
offset is stored.  One int8 byte per entry slot holds the int4 value in the
low nibble and the offset in the high nibble (hence ``m <= 16``).  A tail
group (``rows % m != 0``) may keep fewer than ``n`` rows; its missing slots
are (offset 0, value 0) and add nothing.  ``kernels/nm_fc.py`` and
``kernels/megastep.py`` (``fc_mode="nm"``) read this layout.  The packer
(``pack_nm_groups``), ``flatten`` and the size accounting are not ported
yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.layouts import base


class NMGroupPacked(NamedTuple):
    """Group-packed N:M sparse int4 matrix.

    ``packed[e, c]`` holds entry ``e`` of output channel ``c``: int4 value
    in the low nibble, in-group row offset in the high nibble; its global
    row is ``(e // n) * m + offset``.  Entries run in ascending row order,
    the order padded CSC stores the same mask's survivors, so the two
    layouts execute bit-identically.  A NamedTuple, so that
    ``serving.stream._to`` moves its tensors to the engine's device.
    """

    packed: torch.Tensor  # (ceil(rows / m) * n, N) int8: value | offset << 4
    scale: torch.Tensor  # (1, N) float32
    count: torch.Tensor | None  # (N,) int32 mask survivors per column
    n: int
    m: int
    rows: int  # the matrix's K (m need not divide it)


def nm_index_bits(m: int) -> int:
    """Bits per stored in-group offset."""
    return max(math.ceil(math.log2(max(m, 2))), 1)


def split_nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, N) int8 -> (int4 values as float32, in-group offsets as int32).
    ``>>`` on int8 is arithmetic, so the offset is masked to its nibble."""
    val = packed & 0xF
    val = torch.where(val >= 8, val - 16, val).to(torch.float32)
    off = ((packed >> 4) & 0xF).to(torch.int32)
    return val, off


def _rows(off: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """(E, N) in-group offsets -> global rows ``(e // n) * m + offset``."""
    group = torch.arange(off.shape[0], dtype=torch.int32,
                         device=off.device) // n
    return group[:, None] * m + off


def entry_rows(t: NMGroupPacked) -> torch.Tensor:
    """(E, N) int32 global row of every entry slot."""
    return _rows(split_nibbles(t.packed)[1], t.n, t.m)


def nm_matmul(x: torch.Tensor, t: NMGroupPacked) -> torch.Tensor:
    """Zero-skip matmul oracle: x (B, K) @ N:M-group-packed -> (B, N)
    float32.  ``csc.sparse_matmul``'s order: gather, multiply, sum over the
    entry axis, then scale once."""
    val, off = split_nibbles(t.packed)
    xg = x.to(torch.float32)[:, _rows(off, t.n, t.m).long()]  # (B, E, N)
    acc = (xg * val).sum(dim=1)
    return acc * t.scale


class NMGroupPackedLayout(base.WeightLayout):
    """Fixed-nnz-per-group storage for N:M prune specs."""

    name = "nm_group"
    tensor_type = NMGroupPacked

    def matmul(self, x, t: NMGroupPacked) -> torch.Tensor:
        return nm_matmul(x, t)

    def fc_kernel(self, spikes_ts, t: NMGroupPacked) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels sit above

        return ops.nm_fc(spikes_ts, t.packed, t.scale, n=t.n, m=t.m)

    def megastep_fc(self, t: NMGroupPacked) -> tuple[str, tuple, dict]:
        return "nm", (t.packed, t.scale), {"nm_n": t.n, "nm_m": t.m}

    def unflatten(self, fields) -> NMGroupPacked:
        n, m, rows = (int(v) for v in fields["meta"])
        return NMGroupPacked(packed=fields["packed"], scale=fields["scale"],
                             count=fields["count"], n=n, m=m, rows=rows)


NM_GROUP = base.register_layout(NMGroupPackedLayout())
