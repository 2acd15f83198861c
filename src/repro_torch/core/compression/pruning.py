"""Mixed-level pruning (paper §II-D3).

Structured pruning follows the predefined scheme of the paper's ref. [24]:
shrink the channel width (256 -> 128) and train from scratch — a config
transform (``structured_prune_config``), not a mask.  Every mask-realised
level lives here, dispatched by ``build_mask`` from a
``compress.PruneSpec``:

  * ``magnitude`` — global unstructured magnitude pruning (ref. [25]);
  * ``nm``        — N:M semi-structured sparsity along the input dim;
  * ``row``       — structured: whole input rows by L2 norm;
  * ``channel``   — structured: whole output channels by L2 norm.

All apply to any 2-D weight and run in torch on the weight's device.
Ranks are stable sorts (ties keep row order, as ``jnp.argsort`` does), and
a magnitude or norm mask keeps every entry at or above its threshold, so
it can keep more than its share on ties.
"""

from __future__ import annotations

import dataclasses

import torch


def structured_prune_config(cfg, hidden_dim: int):
    """Predefined structured pruning: the same architecture with narrower
    channels; the FC output width (the decoder interface) is kept."""
    return dataclasses.replace(cfg, hidden_dim=hidden_dim)


def _keep_count(size: int, prune_frac: float) -> int:
    return max(int(round(size * (1.0 - prune_frac))), 1)


def magnitude_prune_mask(w: torch.Tensor, prune_frac: float) -> torch.Tensor:
    """Keep the (1 - prune_frac) largest-|w| entries (and every tie of the
    smallest kept one).  Returns a {0, 1} mask of w's dtype."""
    if prune_frac <= 0.0:
        return torch.ones_like(w)
    a = w.abs()
    thresh = torch.sort(a.reshape(-1)).values[-_keep_count(w.numel(),
                                                           prune_frac)]
    return (a >= thresh).to(w.dtype)


def apply_masks(params: dict, masks: dict) -> dict:
    """Elementwise-apply masks to matching entries; the rest pass through."""
    out = dict(params)
    for name, m in masks.items():
        out[name] = params[name] * m
    return out


def sparsity_of(masks: dict) -> dict:
    return {k: float(1.0 - m.mean()) for k, m in masks.items()}


def nm_prune_mask(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """N:M mask along the input dim: the n largest |w| of every m
    consecutive rows.  A width not divisible by m leaves a tail group of
    r < m rows, which keeps its min(n, r) largest: the tail is padded with
    -inf for the ranking, which never outranks a real weight."""
    rows, cols = w.shape
    padded = -(-rows // m) * m
    a = w.abs()
    if padded != rows:
        pad = torch.full((padded - rows, cols), -torch.inf, dtype=a.dtype,
                         device=a.device)
        a = torch.cat([a, pad])
    g = a.reshape(padded // m, m, cols)
    # rank within each group of m (stable: equal |w| rank by row); keep top-n
    order = torch.argsort(torch.argsort(-g, dim=1, stable=True), dim=1,
                          stable=True)
    return (order < n).to(w.dtype).reshape(padded, cols)[:rows]


def _norm_keep(norms: torch.Tensor, prune_frac: float) -> torch.Tensor:
    """{0, 1} keep-vector over ``norms``: drop the prune_frac smallest."""
    thresh = torch.sort(norms).values[-_keep_count(norms.numel(),
                                                   prune_frac)]
    return (norms >= thresh).to(norms.dtype)


def row_prune_mask(w: torch.Tensor, prune_frac: float) -> torch.Tensor:
    """Structured row pruning: zero whole input rows by L2 norm."""
    if prune_frac <= 0.0:
        return torch.ones_like(w)
    keep = _norm_keep(torch.sqrt((w * w).sum(dim=1)), prune_frac)
    return keep[:, None].expand(w.shape).to(w.dtype).contiguous()


def channel_prune_mask(w: torch.Tensor, prune_frac: float) -> torch.Tensor:
    """Structured channel pruning: zero whole output channels by L2 norm."""
    if prune_frac <= 0.0:
        return torch.ones_like(w)
    keep = _norm_keep(torch.sqrt((w * w).sum(dim=0)), prune_frac)
    return keep[None, :].expand(w.shape).to(w.dtype).contiguous()


def build_mask(w: torch.Tensor, spec) -> torch.Tensor:
    """Dispatch a ``compress.PruneSpec`` to its mask builder."""
    if spec.kind == "magnitude":
        return magnitude_prune_mask(w, spec.frac)
    if spec.kind == "nm":
        return nm_prune_mask(w, spec.n, spec.m)
    if spec.kind == "row":
        return row_prune_mask(w, spec.frac)
    if spec.kind == "channel":
        return channel_prune_mask(w, spec.frac)
    raise ValueError(f"unknown prune kind {spec.kind!r}; expected one of "
                     f"'magnitude', 'nm', 'row', 'channel'")
