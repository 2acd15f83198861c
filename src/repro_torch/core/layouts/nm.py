"""Group-packed N:M layout: fixed ``n`` survivors per ``m``-row group, no
index padding (serving side).

Every group of ``m`` consecutive input rows keeps ``n`` entries, so entry
``e`` of a column belongs to group ``e // n`` and only its
``ceil(log2 m)``-bit in-group row offset is stored: at equal nnz smaller
than padded CSC whenever ``m < K``.  One int8 byte per entry slot holds
the int4 value in the low nibble and the offset in the high nibble (hence
``m <= 16``).  A tail
group (``rows % m != 0``) may keep fewer than ``n`` rows; its missing slots
are (offset 0, value 0) and add nothing; ``count`` records the true mask
survivors for the Fig. 12 accounting.  ``kernels/nm_fc.py`` and
``kernels/megastep.py`` (``fc_mode="nm"``) read this layout.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def pack_nm_groups(q: torch.Tensor, scale: torch.Tensor, keep: torch.Tensor,
                   n: int, m: int) -> NMGroupPacked:
    """Pack an int-quantized matrix whose mask is N:M-regular, on ``q``'s
    device.  ``keep`` must store at most ``n`` entries in every ``m``-row
    group of every column (what ``pruning.nm_prune_mask`` guarantees); a
    tail group may store fewer and is padded with zero-value slots.  A
    group's kept offsets come first, ascending (a stable sort on
    "dropped"), then its pad slots."""
    if not 1 <= n <= m:
        raise ValueError(f"N:M layout needs 1 <= n <= m, got n={n} m={m}")
    if m > 16:
        raise ValueError(
            f"N:M group layout packs the in-group offset into a nibble, "
            f"so m <= 16 is required; got m={m} (use the 'csc' layout)")
    kp = keep.to(torch.bool)
    rows, cols = q.shape
    groups = -(-rows // m)
    pad_rows = groups * m - rows
    qp, kpp = q, kp
    if pad_rows:
        qp = torch.cat([q, q.new_zeros((pad_rows, cols))])
        kpp = torch.cat([kp, kp.new_zeros((pad_rows, cols))])
    qg = qp.reshape(groups, m, cols)
    kg = kpp.reshape(groups, m, cols)
    per_group = kg.sum(dim=1)
    worst = int(per_group.max()) if per_group.numel() else 0
    if worst > n:
        bad = int(per_group.reshape(-1).argmax()) // cols
        raise ValueError(
            f"mask is not {n}:{m}-regular: a group stores {worst} > n={n} "
            f"entries (group {bad}); pack it with the 'csc' layout instead")
    order = torch.argsort((~kg).to(torch.int8), dim=1, stable=True)[:, :n]
    taken = torch.gather(kg, 1, order)
    vals = torch.where(taken, torch.gather(qg, 1, order), 0).to(torch.int16)
    offs = torch.where(taken, order, 0).to(torch.int16)
    byte = (vals & 0xF) | ((offs & 0xF) << 4)
    return NMGroupPacked(
        packed=byte.reshape(groups * n, cols).to(torch.uint8)
        .view(torch.int8),
        scale=scale.to(torch.float32).reshape(1, -1),
        count=kp.sum(dim=0).to(torch.int32), n=n, m=m, rows=rows)


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

    def pack(self, q, scale, *, keep=None, spec=None) -> NMGroupPacked:
        if keep is None:
            raise ValueError("the N:M group layout packs a pruning mask; "
                             "keep= is required")
        if spec is None or getattr(spec, "kind", None) != "nm":
            raise ValueError(
                "the N:M group layout needs the tensor's PruneSpec of kind "
                f"'nm' (its n/m shape the groups); got {spec!r}")
        return pack_nm_groups(q, scale, keep, spec.n, spec.m)

    def unpack(self, t: NMGroupPacked, k_rows: int) -> torch.Tensor:
        val, off = split_nibbles(t.packed)
        dense = torch.zeros((t.rows, val.shape[1]), dtype=torch.float32,
                            device=val.device)
        # scatter-add: pad slots carry value 0 and collide harmlessly
        dense.scatter_add_(0, _rows(off, t.n, t.m).long(), val)
        return dense * t.scale

    def matmul(self, x, t: NMGroupPacked) -> torch.Tensor:
        return nm_matmul(x, t)

    def fc_kernel(self, spikes_ts, t: NMGroupPacked) -> torch.Tensor:
        from repro_torch.kernels import ops  # deferred: kernels sit above

        return ops.nm_fc(spikes_ts, t.packed, t.scale, n=t.n, m=t.m)

    def megastep_fc(self, t: NMGroupPacked) -> tuple[str, tuple, dict]:
        return "nm", (t.packed, t.scale), {"nm_n": t.n, "nm_m": t.m}

    def stored_entries(self, t: NMGroupPacked) -> float:
        return float(t.count.sum())

    def size_bytes(self, t: NMGroupPacked, k_rows: int,
                   bits: int = 4) -> float:
        slots = t.packed.shape[0] * t.packed.shape[1]  # tail padding too
        return slots * (bits + nm_index_bits(t.m)) / 8.0

    def flatten(self, t: NMGroupPacked) -> dict:
        return {"packed": base.host(t.packed), "scale": base.host(t.scale),
                "count": base.host(t.count),
                "meta": np.asarray([t.n, t.m, t.rows], np.int32)}

    def unflatten(self, fields) -> NMGroupPacked:
        n, m, rows = (int(v) for v in fields["meta"])
        return NMGroupPacked(packed=fields["packed"], scale=fields["scale"],
                             count=fields["count"], n=n, m=m, rows=rows)


NM_GROUP = base.register_layout(NMGroupPackedLayout())
