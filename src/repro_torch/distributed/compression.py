"""Gradient compression: int8 quantization with error feedback.

The int8 codec (per-leaf scale) cuts gradient-exchange bytes 4x vs fp32 /
2x vs bf16. Error feedback keeps the quantization noise from biasing
convergence: the residual (g - dq(q(g))) is carried in the train state and
added back before the next compression (1-bit-Adam-style).

The reference's ``distributed/compression.py``, operation for operation:
``torch.round`` rounds half to even as ``jnp.round`` does, and the scale
is divided by a tensor of the gradient's dtype, so q and scale are the
reference's bit for bit.  ``compressed_psum`` takes a
``torch.distributed`` process group where the reference's ``shard_map``
building block takes an axis name.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core import tree as tree_lib


def quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(g.abs().max(), min=1e-12) / torch.full(
        (), 127.0, dtype=g.dtype, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_feedback(params) -> dict:
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def compress_grads(grads, residual):
    """Returns (quantized tree {q, scale}, new residual). Apply BEFORE the
    gradient exchange; `decompress_grads` after."""
    comp, new_res = [], []
    for g, r in zip(tree_lib.tree_leaves(grads), tree_lib.tree_leaves(residual),
                    strict=True):
        g = g.to(torch.float32) + r
        q, s = quantize_leaf(g)
        comp.append({"q": q, "scale": s})
        new_res.append(g - dequantize_leaf(q, s))
    return (tree_lib.tree_unflatten(grads, iter(comp)),
            tree_lib.tree_unflatten(residual, iter(new_res)))


def decompress_grads(comp):
    return tree_lib.tree_map(lambda t: dequantize_leaf(t["q"], t["scale"]),
                             comp, is_leaf=_is_q)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-gather + local fp32 sum over the ranks of ``group`` (the
    default group by default): 4x less interconnect traffic than a fp32
    ring all-reduce at the cost of an fp32 reduction on arrival, each
    rank's ``scale_r * q_r`` summed in rank order.  Raises when no process
    group exists."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("compressed_psum needs a torch.distributed "
                           "process group (init_process_group)")
    q, scale = quantize_leaf(x)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]  # the int8 payload
    ss = [torch.empty(1, dtype=torch.float32, device=q.device)
          for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale.reshape(1), group=group)
    return functools.reduce(
        torch.add, (dequantize_leaf(qr, sr[0]) for qr, sr in zip(qs, ss)))
