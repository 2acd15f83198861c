"""Stacked-layer decoder LM.

Covers the dense archs (internvl2 backbone, gemma2, yi, stablelm, gemma-7b)
and the MLA+MoE archs (deepseek-v3, kimi-k2).  The reference's
``models/transformer.py`` in plain PyTorch.  Its parameter layout is kept:
the leaves of ``params["layers"]`` carry a leading layer axis, and a small
dense prefix (deepseek: 3, kimi: 1) stays a list; a Python loop over that
axis replaces ``jax.lax.scan``.  Gemma2's local/global alternation is
``layer_windows``, one window a stacked layer.  ``cfg.remat == "full"``
checkpoints each stacked layer in train mode, as the reference's
``jax.checkpoint`` on its scan body does (``torch.utils.checkpoint``:
the layer's activations are recomputed in the backward pass).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_alloc_device
from repro_torch.core.tree import (tree_index, tree_map, tree_stack,
                                   tree_unstack)
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers import basic
from repro_torch.models.layers import mla as mla_lib
from repro_torch.models.layers import moe as moe_lib

GLOBAL_WINDOW = 2 ** 30  # "no window" sentinel


# ---------------------------------------------------------------------------
# Per-layer init / forward
# ---------------------------------------------------------------------------


def init_layer(init: basic.ParamInit, cfg, dense_mlp: bool) -> dict:
    """One decoder block. dense_mlp selects plain MLP vs MoE FFN."""
    p: dict[str, Any] = {"attn_norm": basic.init_norm(init, cfg, cfg.d_model),
                         "mlp_norm": basic.init_norm(init, cfg, cfg.d_model)}
    if cfg.mla is not None:
        p["attn"] = mla_lib.init_mla(init, cfg)
    else:
        p["attn"] = attn_lib.init_attn(init, cfg)
    if dense_mlp or cfg.moe is None:
        d_ff = cfg.dense_d_ff or cfg.d_ff
        p["mlp"] = basic.init_mlp(init, cfg, cfg.d_model, d_ff)
    else:
        p["moe"] = moe_lib.init_moe(init, cfg)
    if cfg.sandwich_norm:
        p["post_attn_norm"] = basic.init_norm(init, cfg, cfg.d_model)
        p["post_mlp_norm"] = basic.init_norm(init, cfg, cfg.d_model)
    return p


def layer_fwd(x, lp, cfg, positions, window, cache, cache_pos,
              return_kv=False):
    """One block. window: an int (GLOBAL_WINDOW = full)."""
    h = basic.apply_norm(x, lp["attn_norm"], cfg)
    if cfg.mla is not None:
        a, new_cache = mla_lib.mla_attention(h, lp["attn"], cfg, positions,
                                             cache, cache_pos,
                                             return_kv=return_kv)
    else:
        a, new_cache = attn_lib.attention(h, lp["attn"], cfg, positions,
                                          layer_window=window, cache=cache,
                                          cache_pos=cache_pos,
                                          return_kv=return_kv)
    if cfg.sandwich_norm:
        a = basic.apply_norm(a, lp["post_attn_norm"], cfg)
    x = x + a

    h = basic.apply_norm(x, lp["mlp_norm"], cfg)
    if "moe" in lp:
        f = moe_lib.moe_apply(h, lp["moe"], cfg)
    else:
        f = basic.mlp(h, lp["mlp"], cfg)
    if cfg.sandwich_norm:
        f = basic.apply_norm(f, lp["post_mlp_norm"], cfg)
    return x + f, new_cache


# ---------------------------------------------------------------------------
# Whole-model init / forward
# ---------------------------------------------------------------------------


def layer_windows(cfg) -> torch.Tensor:
    """Per-stacked-layer sliding windows (gemma2: even layers local),
    (num_layers - dense_layers,) int32."""
    idx = torch.arange(cfg.dense_layers, cfg.num_layers)
    if cfg.attn_type == "local_global" and cfg.sliding_window:
        return torch.where(idx % 2 == 0, cfg.sliding_window,
                           GLOBAL_WINDOW).to(torch.int32)
    return torch.full(idx.shape, GLOBAL_WINDOW, dtype=torch.int32)


def init_lm(generator: torch.Generator, cfg,
            device: torch.device | str = "cuda") -> dict:
    """The parameter tree, drawn from ``generator`` (``basic.ParamInit``);
    ``device="meta"`` gives shapes and dtypes only."""
    init = basic.ParamInit(generator, device)
    n_scan = cfg.num_layers - cfg.dense_layers
    params: dict[str, Any] = {"embed": basic.init_embedding(init, cfg)}
    if cfg.dense_layers:
        params["dense_prefix"] = [init_layer(init, cfg, dense_mlp=True)
                                  for _ in range(cfg.dense_layers)]
    params["layers"] = init_layer(init.stacked(n_scan), cfg, dense_mlp=False)
    params["final_norm"] = basic.init_norm(init, cfg, cfg.d_model)
    return params


class DecodeCache(NamedTuple):
    prefix: list  # per-dense-prefix-layer cache
    layers: Any  # stacked-layer caches, leaves stacked on axis 0
    pos: torch.Tensor  # (B,) next write position


def init_decode_cache(cfg, batch: int, max_len: int,
                      device: torch.device | str = "cuda") -> DecodeCache:
    device = resolve_alloc_device(device)  # meta: shapes only
    n_scan = cfg.num_layers - cfg.dense_layers
    if cfg.mla is not None:
        def one():
            return mla_lib.init_mla_cache(cfg, batch, max_len, device=device)
    else:
        def one():
            return attn_lib.init_kv_cache(cfg, batch, max_len, device=device)
    prefix = [one() for _ in range(cfg.dense_layers)]
    stacked = tree_map(lambda x: x.new_zeros((n_scan, *x.shape)), one())
    return DecodeCache(prefix=prefix, layers=stacked,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def lm_forward(params, tokens, cfg, frontend_embeds=None,
               cache: DecodeCache | None = None, mode: str = "train"):
    """tokens: (B, S). mode: 'train' | 'prefill' | 'decode'.

    decode: cache is updated at cache.pos (S == 1).
    prefill: per-layer post-rope K/V are collected into a fresh DecodeCache
    and only the last position's logits are computed.
    Returns (logits, new_cache)."""
    if cache is not None:
        mode = "decode"
    b, s = tokens.shape
    x = basic.embed_tokens(tokens, params["embed"], cfg)
    if frontend_embeds is not None:
        x = basic.splice_frontend_embeddings(x, frontend_embeds)

    if mode == "decode":
        positions = cache.pos[:, None]
        cache_pos = cache.pos
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        cache_pos = None

    windows = layer_windows(cfg).tolist()
    prefill = mode == "prefill"

    # --- unrolled dense prefix ---------------------------------------------
    new_prefix = []
    for i in range(cfg.dense_layers):
        c = cache.prefix[i] if mode == "decode" else None
        x, nc = layer_fwd(x, params["dense_prefix"][i], cfg, positions,
                          GLOBAL_WINDOW, c, cache_pos, return_kv=prefill)
        new_prefix.append(nc)

    # --- stacked layers ------------------------------------------------------
    fwd = layer_fwd
    if cfg.remat == "full" and mode == "train":
        fwd = functools.partial(checkpoint, layer_fwd, use_reentrant=False)
    layer_caches = []
    for i, (window, lp) in enumerate(zip(windows,
                                         tree_unstack(params["layers"]))):
        c = tree_index(cache.layers, i) if mode == "decode" else None
        x, nc = fwd(x, lp, cfg, positions, window, c, cache_pos,
                    return_kv=prefill)
        layer_caches.append(nc)

    if mode == "decode":
        new_cache = DecodeCache(prefix=new_prefix,
                                layers=tree_stack(layer_caches),
                                pos=cache.pos + 1)
    elif prefill:
        new_cache = DecodeCache(prefix=new_prefix,
                                layers=tree_stack(layer_caches),
                                pos=torch.full((b,), s, dtype=torch.int32,
                                               device=x.device))
    else:
        new_cache = None

    if prefill:
        x = x[:, -1:]  # only the last position feeds sampling
    x = basic.apply_norm(x, params["final_norm"], cfg)
    logits = basic.unembed(x, params["embed"], cfg)
    return logits, new_cache
