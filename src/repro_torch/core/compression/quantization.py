"""The int4 nibble codec, read side (paper §II-D3).

Two int4 values per byte along the leading axis: the low nibble is even
row ``2i``, the high nibble row ``2i+1``, each sign-extended from [0, 15]
to [-8, 7].  The packing side (``pack_int4``) is not ported yet.
"""

from __future__ import annotations

import torch


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(k, n) int8 nibble pairs -> (2k, n) int8 in [-8, 7]."""
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1)  # (k, 2, n)
    return out.reshape(packed.shape[0] * 2, *packed.shape[1:]).to(torch.int8)
