"""Placement of the streaming engine's slot state over a list of devices.

The stream half of the reference's ``distributed/sharding.py``
(``stream_state_specs``, ``stream_shardings``, ``stream_ring_spec``).  The
reference names, for each leaf, the mesh axis its slot dimension shards
over; here a spec is the slot dimension itself, and ``shard_state`` /
``gather_state`` stand for ``device_put`` with those shardings: they split
a state along its slot dimensions into contiguous copies, one a device,
and join such copies back.  ``serving/sharded.py`` places its slot state
with them; the weights are replicated (``CompiledRSNN.place_weights``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _slot_dim(leaf: torch.Tensor) -> int | None:
    if leaf.dim() >= 3:
        return 1
    return 0 if leaf.dim() >= 1 else None


def stream_state_specs(state):
    """Each leaf's slot dimension, in the state's structure.

    The convention of ``core.rsnn.RSNNState``: a leaf of 3 or more
    dimensions is a (TS, B, H) spike train (slot dimension 1), a 2-D leaf
    a (B, H) LIF carry and a 1-D leaf a per-slot scalar (slot dimension
    0); a 0-D leaf has none (``None``: replicated).  The delta backend's
    carries (``serving.stream.DeltaRSNNState``: held inputs (B, D), cached
    pre-activation (B, H)) follow the 2-D rule with no case of their own.
    """
    if isinstance(state, torch.Tensor):
        return _slot_dim(state)
    return type(state)(*(stream_state_specs(f) for f in state))


def stream_ring_spec() -> int:
    """The slot dimension of the serving loops' slot-major device buffers,
    the frame buffer ``(slots, max_frames, input_dim)`` and the v2 logit
    ring ``(slots, ring_frames, fc_dim)``: 0.  A slot's frame and ring rows
    stay on its own device and its ring rows are harvested as one
    contiguous slice."""
    return 0


def shard_state(state, devices: Sequence[torch.device | str]) -> list:
    """Split ``state`` along each leaf's slot dimension
    (``stream_state_specs``) into ``len(devices)`` equal, contiguous parts,
    part k a copy on ``devices[k]``; a 0-D leaf is copied whole to each.
    Returns the parts, each in the state's structure."""
    n = len(devices)
    if isinstance(state, torch.Tensor):
        dim = _slot_dim(state)
        if dim is None:
            parts = [state] * n
        elif state.shape[dim] % n:
            raise ValueError(f"slot dimension {dim} of a {tuple(state.shape)}"
                             f" leaf does not split over {n} devices")
        else:
            parts = state.chunk(n, dim)
        return [p.to(d, copy=True, memory_format=torch.contiguous_format)
                for p, d in zip(parts, devices)]
    return [type(state)(*fields) for fields in
            zip(*(shard_state(f, devices) for f in state))]


def gather_state(shards: Sequence, device: torch.device | str | None = None):
    """The inverse of ``shard_state``: the parts joined along each leaf's
    slot dimension on ``device`` (by default the first part's); a 0-D
    leaf is taken from the first part."""
    first = shards[0]
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else device
        dim = _slot_dim(first)
        if dim is None:
            return first.to(dev)
        return torch.cat([s.to(dev) for s in shards], dim)
    return type(first)(*(gather_state(list(f), device)
                         for f in zip(*shards)))
