"""Grouped-query attention with sliding-window / softcap / KV-cache support.

Covers: internvl2 (GQA 48/8), gemma2 (alt. local/global, softcap, hd 256),
yi (GQA 32/4), stablelm (MHA, partial rotary), gemma-7b (MQA-ish 16/16,
hd 256), whisper (MHA, no rope, cross-attention), zamba2's shared block.

The reference's ``models/layers/attention.py`` in plain PyTorch.  The
logits are float32 products of the operands (bf16 values multiply exactly
in float32), scaled, softcapped and masked with ``NEG_INF`` (not -inf)
before a float32 softmax, as the reference computes them; an explicit
einsum, not ``scaled_dot_product_attention``, because the softcap and the
mask constant are part of the function.  The reference's sharding
constraints are the identity on one device and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import basic

NEG_INF = -2.3819763e38  # large negative for masking in fp32


class KVCache(NamedTuple):
    """Pre-allocated decode cache. k/v: (B, T_max, Hkv, hd)."""

    k: torch.Tensor
    v: torch.Tensor


def init_attn(init: basic.ParamInit, cfg, d_model: int | None = None,
              rope: bool = True, cross: bool = False) -> dict:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    s = d ** -0.5
    return {
        "w_q": init.normal((d, cfg.num_heads * hd), cfg.dtype, s),
        "w_k": init.normal((d, cfg.num_kv_heads * hd), cfg.dtype, s),
        "w_v": init.normal((d, cfg.num_kv_heads * hd), cfg.dtype, s),
        "w_o": init.normal((cfg.num_heads * hd, d), cfg.dtype,
                           (cfg.num_heads * hd) ** -0.5),
    }


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _attn_core(q, k, v, mask, cfg):
    """q: (B,Sq,Hq,hd); k,v: (B,Skv,Hkv,hd); mask broadcastable to
    (B,Hkv,G,Sq,Skv). fp32 logits and softmax, probabilities cast to v's
    dtype for the PV product."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q = q.reshape(b, sq, hkv, g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    logits = logits * (cfg.resolved_head_dim ** -0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq * hd)


def causal_mask(sq: int, skv: int, q_offset: torch.Tensor | int = 0,
                window: int | None = None, device=None) -> torch.Tensor:
    """(1,1,1,Sq,Skv) boolean mask; window = sliding-window size."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


def attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
              layer_window: int | None = None, cache: KVCache | None = None,
              cache_pos: torch.Tensor | None = None, rope: bool = True,
              kv_x: torch.Tensor | None = None, return_kv: bool = False,
              ) -> tuple[torch.Tensor, KVCache | None]:
    """Full GQA layer. In decode mode (cache given) x is (B,1,D) and the
    cache is updated at cache_pos. kv_x enables cross-attention. In prefill
    mode (return_kv) the computed post-rope K/V are returned as a cache."""
    hd = cfg.resolved_head_dim
    src = x if kv_x is None else kv_x
    q = _split_heads(x @ p["w_q"], cfg.num_heads, hd)
    k = _split_heads(src @ p["w_k"], cfg.num_kv_heads, hd)
    v = _split_heads(src @ p["w_v"], cfg.num_kv_heads, hd)
    if rope:
        q = basic.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
        kpos = positions if cache is None else cache_pos[:, None]
        k = basic.apply_rope(k, kpos, cfg.rope_theta, cfg.rotary_pct)

    if cache is not None and kv_x is None:  # self-attention decode
        k_cache = _scatter_cache(cache.k, k, cache_pos)
        v_cache = _scatter_cache(cache.v, v, cache_pos)
        t = cache.k.shape[1]
        kpos_all = torch.arange(t, device=x.device)[None, None, None, None, :]
        qpos = cache_pos[:, None, None, None, None]
        mask = kpos_all <= qpos
        if layer_window is not None:
            mask &= kpos_all > qpos - layer_window
        out = _attn_core(q, k_cache.to(q.dtype), v_cache.to(q.dtype), mask,
                         cfg)
        new_cache = KVCache(k=k_cache, v=v_cache)
    else:
        if kv_x is not None:  # cross-attention: full visibility
            mask = torch.ones((1, 1, 1, q.shape[1], k.shape[1]), dtype=bool,
                              device=x.device)
        else:
            mask = causal_mask(q.shape[1], k.shape[1], 0, layer_window,
                               device=x.device)
        out = _attn_core(q, k, v, mask, cfg)
        new_cache = KVCache(k=k, v=v) if (return_kv and kv_x is None) \
            else None
    return out @ p["w_o"], new_cache


def _scatter_cache(cache: torch.Tensor, kv: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Write kv (B,1,...) into cache (B,T,...) at per-batch position pos (B,),
    returning a new cache as the reference's scatter does.

    The write is masked per row: row b takes kv at the one cache row whose
    index equals pos[b].  A row whose pos is past the cache (pos >= T) hits
    no index and is left as it was, which is what the reference's scatter
    does with an out-of-bounds index (JAX drops the write).  A plain indexed
    write would raise on the CPU and assert on the card instead."""
    b, t = cache.shape[:2]
    hit = torch.arange(t, device=cache.device)[None, :] == pos[:, None]
    hit = hit.reshape(b, t, *(1,) * (cache.ndim - 2))
    return torch.where(hit, kv.to(cache.dtype), cache)


def init_kv_cache(cfg, batch: int, max_len: int, dtype=None,
                  device: torch.device | str = "cuda") -> KVCache:
    hd = cfg.resolved_head_dim
    dt = dtype or cfg.dtype
    shape = (batch, max_len, cfg.num_kv_heads, hd)
    return KVCache(k=torch.zeros(shape, dtype=dt, device=device),
                   v=torch.zeros(shape, dtype=dt, device=device))
