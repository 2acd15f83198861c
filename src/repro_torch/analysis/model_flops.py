"""MODEL_FLOPS: the useful-compute yardstick for the roofline ratio.

train:   6 * N_active * tokens   (fwd 2ND + bwd 4ND)
prefill: 2 * N_active * tokens
decode:  2 * N_active * batch    (one token per sequence per step)

N_active = matmul-participating params; for MoE, routed experts count at
top_k/num_experts of their size (the ideal dropless activation). The token
embedding lookup is not a matmul and is excluded; the unembed projection is
included (tied or not).

The shapes come from ``ModelAPI.init`` on the ``meta`` device, which
allocates nothing (the reference's ``jax.eval_shape``), and the leaf paths
from ``core/tree.py`` ``tree_leaves_with_path``, written as the
reference's ``keystr`` writes them, so the classification below is the
reference's string for string.  The train count leaves remat's recomputed
forward out: a step with ``remat="full"`` does about 8 N T.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import tree_leaves_with_path
from repro_torch.models import registry


@functools.lru_cache(maxsize=None)
def param_counts(arch: str) -> dict:
    api = registry.get_model(arch)
    cfg = api.cfg
    shapes = api.init(torch.Generator(), device="meta")
    total = 0
    embed_tok = 0
    routed = 0
    for ks, leaf in tree_leaves_with_path(shapes):
        n = leaf.numel()
        total += n
        if ks.endswith("['tok']"):
            embed_tok = n
        if "['moe']" in ks and any(ks.endswith(f"['{w}']")
                                   for w in ("w_gate", "w_up", "w_down")):
            routed += n
    n_matmul = total - embed_tok + (embed_tok if cfg.tie_embeddings else 0)
    active = n_matmul - routed
    if cfg.moe is not None and routed:
        active += routed * cfg.moe.top_k / cfg.moe.num_experts
    return {"total": total, "matmul": n_matmul, "active": int(active),
            "routed": routed}


def model_flops(arch: str, shape: ShapeConfig) -> float:
    n = param_counts(arch)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token / sequence


def model_bytes_decode(arch: str, shape: ShapeConfig) -> float:
    """Ideal HBM bytes for one decode step: every active weight read once
    (bf16) + the KV/state read for the batch. Used for the memory-side
    roofline narrative on decode shapes."""
    n = param_counts(arch)["active"]
    return 2.0 * n  # weight reads dominate at small batch
