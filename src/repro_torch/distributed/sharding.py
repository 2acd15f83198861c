"""Sharding rules: partition specs from a leaf's path, shape and a mesh.

The token-LM half is the reference's ``distributed/sharding.py``, rule
for rule:
  * batch shards over the data axes ('pod','data') when divisible;
  * TP ('model'): attention heads / FFN hidden / vocab / experts, by leaf
    name, only when the dim divides the axis;
  * FSDP ('data'): the non-TP large dim of every >=2D parameter;
  * stacked-layer prefixes ('layers', 'groups', 'tail', 'enc/dec_layers')
    get a leading None;
  * caches/recurrent state: batch dim over data axes; when B=1 (long_500k)
    the sequence dim of KV caches shards over 'data' (context parallelism)
    and head/state dims over 'model'.
Every rule degrades to replication when a dim does not divide.  A spec is
``core.tree.PartitionSpec``, a tuple equal to ``tuple(P(...))`` of the
reference's; a mesh is anything with ``axis_names`` and a ``shape``
mapping (``launch/mesh.py`` ``Mesh``, or a stand-in with the sizes only).
``runtime/elastic.py`` places a tree by these specs, one part a device.

The stream half (``stream_state_specs``, ``stream_shardings``,
``stream_ring_spec``) places the streaming engine's slot state.  The
reference names, for each leaf, the mesh axis its slot dimension shards
over; here a spec is the slot dimension itself, and ``shard_state`` /
``gather_state`` stand for ``device_put`` with those shardings: they split
a state along its slot dimensions into contiguous copies, one a device,
and join such copies back.  ``serving/sharded.py`` places its slot state
with them; the weights are replicated (``CompiledRSNN.place_weights``).
"""

from __future__ import annotations

import re
from typing import Any, Sequence

import torch

from repro_torch.core.tree import (PartitionSpec as P, tree_leaves_with_path,
                                   tree_map, tree_unflatten)

STACKED = re.compile(r"\['(layers|groups|tail|dec_layers|enc_layers|dense_prefix)'\]")

# leaf name -> (tp_dim, fsdp_dim) counted from the END of the (unstacked) shape
_COL_PARALLEL = {"w_q", "w_k", "w_v", "w_gate", "w_up", "w_uq", "w_uk", "w_uv",
                 "w_ff_gate", "w_ff_up", "w_in", "w_if", "w_o_gate",
                 # RSNN layers: hidden/FC output dims shard over 'model'
                 "l0_wx", "l0_wh", "l1_wx", "l1_wh", "fc_w"}
_ROW_PARALLEL = {"w_o", "w_down", "w_ff_down", "w_out"}
_REPLICATED = {"router", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
               "b_if", "b_gates", "vth", "scale", "bias", "dec_pos",
               "q_norm", "kv_norm", "raw_beta", "raw_vth", "b_up", "b_down",
               "w_kr", "w_dq", "w_dkv", "r_gates", "w_gates"}


def _leaf_name(pathstr: str) -> str:
    m = re.findall(r"\['([^']+)'\]|\.(\w+)$", pathstr)
    last = m[-1] if m else ("", "")
    return last[0] or last[1]


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0 and n >= mesh.shape[axis]


def _data_axes_for(n: int, mesh) -> Any:
    """Largest prefix of ('pod','data') that divides n."""
    axes = []
    size = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            size *= mesh.shape[a]
            axes.append(a)
    if axes and n % size == 0 and n > 0:
        return tuple(axes) if len(axes) > 1 else axes[0]
    # try 'data' alone
    if _div(n, mesh, "data"):
        return "data"
    return None


def param_spec(pathstr: str, shape: tuple[int, ...], mesh) -> P:
    name = _leaf_name(pathstr)
    nd = len(shape)
    n_stack = len(STACKED.findall(pathstr))
    spec = [None] * nd
    if nd - n_stack < 2 or name in _REPLICATED:
        # 1-D / scalar / explicitly replicated params. Still FSDP-shard big
        # replicated 2D+ leaves (e.g. mamba w_in/w_gates) over 'data'.
        if nd - n_stack >= 2 and name not in {"router", "dec_pos", "conv_w"}:
            if _div(shape[-2], mesh, "data"):
                spec[-2] = "data"
            if name in _COL_PARALLEL and _div(shape[-1], mesh, "model"):
                spec[-1] = "model"
        return P(*spec)

    is_expert = "['moe']" in pathstr and name in ("w_gate", "w_up", "w_down")
    if is_expert and nd - n_stack == 3:
        e_dim = nd - 3
        if _div(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"  # expert parallelism
        fsdp_dim = nd - 2 if name in ("w_gate", "w_up") else nd - 1
        if _div(shape[fsdp_dim], mesh, "data"):
            spec[fsdp_dim] = "data"
        return P(*spec)

    if name == "tok":  # (V, D): vocab over model, D over data
        if _div(shape[-2], mesh, "model"):
            spec[-2] = "model"
        if _div(shape[-1], mesh, "data"):
            spec[-1] = "data"
        return P(*spec)
    if name == "unembed":  # (D, V)
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
        if _div(shape[-2], mesh, "data"):
            spec[-2] = "data"
        return P(*spec)

    if name in _COL_PARALLEL:
        tp_dim, fsdp_dim = nd - 1, nd - 2
    elif name in _ROW_PARALLEL:
        tp_dim, fsdp_dim = nd - 2, nd - 1
    else:  # unknown 2D leaf: fsdp the bigger dim
        tp_dim, fsdp_dim = None, (nd - 2 if shape[-2] >= shape[-1] else nd - 1)
    if tp_dim is not None and _div(shape[tp_dim], mesh, "model"):
        spec[tp_dim] = "model"
    if _div(shape[fsdp_dim], mesh, "data"):
        spec[fsdp_dim] = "data"
    return P(*spec)


# --- caches / recurrent state ------------------------------------------------


def cache_spec(pathstr: str, shape: tuple[int, ...], mesh, batch: int) -> P:
    """The batch dim is the FIRST dim of size ``batch``, as in the
    reference, even where a stacked layer axis has that size."""
    nd = len(shape)
    batch_dim = next((i for i, s in enumerate(shape) if s == batch), None)
    spec: list[Any] = [None] * nd
    dax = _data_axes_for(batch, mesh)
    if batch_dim is not None and dax is not None and batch > 1:
        spec[batch_dim] = dax
        # shard a head/state dim over model if possible
        for i in range(nd - 1, batch_dim, -1):
            if _div(shape[i], mesh, "model"):
                spec[i] = "model"
                break
        return P(*spec)
    # B too small: context-parallel — shard the longest dim over 'data',
    # a later dim over 'model'
    order = sorted(range(nd), key=lambda i: -shape[i])
    for i in order:
        if _div(shape[i], mesh, "data"):
            spec[i] = "data"
            break
    for i in order:
        if spec[i] is None and _div(shape[i], mesh, "model"):
            spec[i] = "model"
            break
    return P(*spec)


# --- tree-level helpers -------------------------------------------------------


def _tree_specs(tree, spec_of):
    """``spec_of(path, shape)`` over the leaves of ``tree`` (tensors, meta
    ones included), in ``tree``'s structure."""
    specs = [spec_of(p, tuple(leaf.shape))
             for p, leaf in tree_leaves_with_path(tree)]
    return tree_unflatten(tree, iter(specs))


def tree_param_specs(tree, mesh):
    return _tree_specs(tree, lambda p, shape: param_spec(p, shape, mesh))


def tree_cache_specs(tree, mesh, batch: int):
    return _tree_specs(
        tree, lambda p, shape: cache_spec(p, shape, mesh, batch))


def batch_specs(batch_tree, mesh):
    def spec(leaf):
        dax = _data_axes_for(leaf.shape[0], mesh)
        return P(dax, *([None] * (leaf.dim() - 1)))
    return tree_map(spec, batch_tree)


# --- activation hints ---------------------------------------------------------

_ACTIVE_AXES: dict[str, int] = {}


def set_activation_axes(mesh) -> None:
    """Record mesh axis names/sizes, which ``axis_size``, ``shardable``
    and the ``constrain*`` hints read (``launch/train.py`` registers its
    mesh before training)."""
    global _ACTIVE_AXES
    if mesh is None:
        _ACTIVE_AXES = {}
    else:
        _ACTIVE_AXES = {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_size(axis: str) -> int:
    return _ACTIVE_AXES.get(axis, 1)


def _batch_axes(n: int):
    """Largest prefix of ('pod','data') whose product divides n."""
    axes = [a for a in ("pod", "data") if a in _ACTIVE_AXES]
    size = 1
    for a in axes:
        size *= _ACTIVE_AXES[a]
    if axes and n % size == 0 and n >= size:
        return tuple(axes) if len(axes) > 1 else axes[0]
    if "data" in _ACTIVE_AXES and n % _ACTIVE_AXES["data"] == 0 and n >= _ACTIVE_AXES["data"]:
        return "data"
    return None


def shardable(n: int, axis: str) -> bool:
    return axis in _ACTIVE_AXES and n % _ACTIVE_AXES[axis] == 0 and n >= _ACTIVE_AXES[axis]


# The reference's activation sharding hints (``with_sharding_constraint``
# under its SPMD partitioner).  The port runs one process with no
# partitioner, so a hint has nothing to act on: each returns ``x`` as it
# is, with or without registered axes.  The forwards do not call them.


def constrain(x, spec: P):
    return x


def constrain_batch(x, model_dim: int | None = None):
    return x


def constrain_dim(x, dim: int, axis: str):
    return x


def constrain_last_dim(x, axis: str = "model"):
    return x


def constrain_dims(x, dims: dict[int, str]):
    return x


# --- streaming RSNN serving state --------------------------------------------


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


def stream_shardings(state, mesh, axis: str = "data") -> tuple:
    """``stream_state_specs(state)`` with the devices of ``mesh`` along
    ``axis`` (the other axes at index 0): the two things ``shard_state``
    takes, the reference's ``NamedSharding``s of the same specs."""
    k = mesh.axis_names.index(axis)
    index = [0] * len(mesh.axis_names)
    index[k] = slice(None)
    return stream_state_specs(state), list(mesh.devices[tuple(index)])


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
