"""Zamba2-style hybrid: Mamba2 backbone + a SHARED attention block applied
every `attn_every` layers (one set of weights reused at every
application).

Structure: n_groups super-blocks, each = `attn_every` stacked Mamba2
layers + one application of the shared attention/MLP block; plus a tail
of leftover Mamba2 layers.  Decode carries Mamba2 states per layer + one KV
cache per shared-block application.

The reference's ``models/hybrid.py`` in plain PyTorch: the ``groups``
leaves keep their two stacked axes (n_groups, g, ...) and the ``tail``
leaves one, and Python loops over them replace the nested
``jax.lax.scan``.  ``cfg.remat == "full"`` checkpoints each Mamba2 layer
in train mode, called with no state (``torch.utils.checkpoint`` where the
reference calls ``jax.checkpoint``; the shared attention block is not
checkpointed, in the reference either).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_alloc_device
from repro_torch.core.tree import (tree_index, tree_map, tree_stack,
                                   tree_unstack)
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import basic
from repro_torch.models.layers import mamba2 as m2

GLOBAL_WINDOW = 2 ** 30  # "no window" sentinel


def _split(cfg) -> tuple[int, int, int]:
    g = cfg.attn_every
    n_groups = cfg.num_layers // g
    tail = cfg.num_layers - n_groups * g
    return g, n_groups, tail


def _init_mamba_layer(init: basic.ParamInit, cfg) -> dict:
    return {"norm": basic.init_norm(init, cfg, cfg.d_model),
            "mamba": m2.init_mamba2(init, cfg)}


def init_hybrid(generator: torch.Generator, cfg,
                device: torch.device | str = "cuda") -> dict:
    """The parameter tree, drawn from ``generator`` (``basic.ParamInit``);
    ``device="meta"`` gives shapes and dtypes only."""
    g, n_groups, tail = _split(cfg)
    init = basic.ParamInit(generator, device)
    params: dict[str, Any] = {
        "embed": basic.init_embedding(init, cfg),
        # leaves: (n_groups, g, ...)
        "groups": _init_mamba_layer(init.stacked(g).stacked(n_groups), cfg),
        "shared_attn": {
            "attn_norm": basic.init_norm(init, cfg, cfg.d_model),
            "attn": attn_lib.init_attn(init, cfg),
            "mlp_norm": basic.init_norm(init, cfg, cfg.d_model),
            "mlp": basic.init_mlp(init, cfg, cfg.d_model, cfg.d_ff),
        },
        "final_norm": basic.init_norm(init, cfg, cfg.d_model),
    }
    if tail:
        params["tail"] = _init_mamba_layer(init.stacked(tail), cfg)
    return params


class HybridCache(NamedTuple):
    group_states: Any  # Mamba2State leaves stacked (n_groups, g, ...)
    tail_states: Any  # (tail, ...), or None with no tail
    attn_caches: Any  # KVCache leaves stacked (n_groups, ...)
    pos: torch.Tensor


def init_hybrid_cache(cfg, batch: int, max_len: int,
                      device: torch.device | str = "cuda") -> HybridCache:
    g, n_groups, tail = _split(cfg)
    device = resolve_alloc_device(device)  # meta: shapes only
    one = m2.init_mamba2_state(cfg, batch, device)

    def stack(n, tree):
        return tree_map(lambda x: x.new_zeros((n, *x.shape)), tree)

    kv = attn_lib.init_kv_cache(cfg, batch, max_len, device=device)
    return HybridCache(
        group_states=stack(n_groups, stack(g, one)),
        tail_states=stack(tail, one) if tail else None,
        attn_caches=stack(n_groups, kv),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _shared_attn(x, p, cfg, positions, cache, cache_pos, return_kv=False):
    h = basic.apply_norm(x, p["attn_norm"], cfg)
    a, nc = attn_lib.attention(h, p["attn"], cfg, positions,
                               layer_window=GLOBAL_WINDOW, cache=cache,
                               cache_pos=cache_pos, return_kv=return_kv)
    x = x + a
    h = basic.apply_norm(x, p["mlp_norm"], cfg)
    return x + basic.mlp(h, p["mlp"], cfg), nc


def hybrid_forward(params, tokens, cfg, cache: HybridCache | None = None,
                   mode: str = "train"):
    _, _, tail = _split(cfg)
    b, s = tokens.shape
    x = basic.embed_tokens(tokens, params["embed"], cfg)
    decode = cache is not None
    mode = "decode" if decode else mode
    prefill = mode == "prefill"
    if decode:
        positions = cache.pos[:, None]
        cache_pos = cache.pos
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        cache_pos = None

    def mamba_stack(x, layers, states):
        """Stacked Mamba2 layers; their new states stacked."""
        new = []
        for j, lp in enumerate(tree_unstack(layers)):
            h = basic.apply_norm(x, lp["norm"], cfg)
            if cfg.remat == "full" and mode == "train":
                out, ns = checkpoint(m2.mamba2_layer, h, lp["mamba"], cfg,
                                     None, use_reentrant=False)
            else:
                out, ns = m2.mamba2_layer(
                    h, lp["mamba"], cfg,
                    tree_index(states, j) if states is not None else None)
            x = x + out
            new.append(ns)
        return x, tree_stack(new)

    group_states, kvs = [], []
    for i, group in enumerate(tree_unstack(params["groups"])):
        x, ns = mamba_stack(
            x, group, tree_index(cache.group_states, i) if decode else None)
        x, kv = _shared_attn(
            x, params["shared_attn"], cfg, positions,
            tree_index(cache.attn_caches, i) if decode else None, cache_pos,
            return_kv=prefill)
        group_states.append(ns)
        kvs.append(kv)

    new_tail = None
    if tail:
        x, new_tail = mamba_stack(x, params["tail"],
                                  cache.tail_states if decode else None)

    if prefill:
        x = x[:, -1:]
    x = basic.apply_norm(x, params["final_norm"], cfg)
    logits = basic.unembed(x, params["embed"], cfg)
    if not (decode or prefill):
        return logits, None
    pos = cache.pos + 1 if decode else \
        torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, HybridCache(group_states=tree_stack(group_states),
                               tail_states=new_tail,
                               attn_caches=tree_stack(kvs), pos=pos)
