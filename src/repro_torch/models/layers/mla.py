"""Multi-head Latent Attention (DeepSeek-V3 / Kimi-K2).

Queries and keys/values are projected through low-rank latents; the decode
cache stores only the compressed KV latent (kv_lora_rank) plus the shared
RoPE key (qk_rope_head_dim) — the paper-family's KV-memory saving.

The reference's ``models/layers/mla.py`` in plain PyTorch: float32 logits,
``NEG_INF`` masking, float32 softmax, and the decode write masked per row
as ``attention._scatter_cache`` writes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import basic
from repro_torch.models.layers.attention import NEG_INF, _scatter_cache


class MLACache(NamedTuple):
    kv_latent: torch.Tensor  # (B, T, kv_lora_rank)
    k_rope: torch.Tensor  # (B, T, qk_rope_head_dim)


def init_mla(init: basic.ParamInit, cfg) -> dict:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.num_heads
    s = d ** -0.5
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = cfg.dtype
    return {
        "w_dq": init.normal((d, m.q_lora_rank), dt, s),
        "q_norm": init.zeros((m.q_lora_rank,), dt),
        "w_uq": init.normal((m.q_lora_rank, h * qk_head), dt,
                            m.q_lora_rank ** -0.5),
        "w_dkv": init.normal((d, m.kv_lora_rank), dt, s),
        "kv_norm": init.zeros((m.kv_lora_rank,), dt),
        "w_kr": init.normal((d, m.qk_rope_head_dim), dt, s),
        "w_uk": init.normal((m.kv_lora_rank, h * m.qk_nope_head_dim), dt,
                            m.kv_lora_rank ** -0.5),
        "w_uv": init.normal((m.kv_lora_rank, h * m.v_head_dim), dt,
                            m.kv_lora_rank ** -0.5),
        "w_o": init.normal((h * m.v_head_dim, d), dt,
                           (h * m.v_head_dim) ** -0.5),
    }


def mla_attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                  cache: MLACache | None = None,
                  cache_pos: torch.Tensor | None = None,
                  return_kv: bool = False,
                  ) -> tuple[torch.Tensor, MLACache | None]:
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.num_heads

    # --- queries through the q-latent -----------------------------------
    q_lat = basic.rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (q_lat @ p["w_uq"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = basic.apply_rope(q_rope, positions, cfg.rope_theta)

    # --- compressed KV latent + shared rope key ---------------------------
    kv_lat = basic.rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    kpos = positions if cache is None else cache_pos[:, None]
    k_rope = basic.apply_rope((x @ p["w_kr"])[:, :, None, :], kpos,
                              cfg.rope_theta)[:, :, 0]

    if cache is not None:
        kv_lat = _scatter_cache(cache.kv_latent, kv_lat, cache_pos)
        k_rope = _scatter_cache(cache.k_rope, k_rope, cache_pos)
        new_cache = MLACache(kv_latent=kv_lat, k_rope=k_rope)
        kv_lat, k_rope = kv_lat.to(x.dtype), k_rope.to(x.dtype)
    else:
        new_cache = MLACache(kv_latent=kv_lat, k_rope=k_rope) \
            if return_kv else None

    t = kv_lat.shape[1]
    k_nope = (kv_lat @ p["w_uk"]).reshape(b, t, h, m.qk_nope_head_dim)
    v = (kv_lat @ p["w_uv"]).reshape(b, t, h, m.v_head_dim)

    # --- attention scores: nope part + shared rope part -------------------
    logits = torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope.float())
    logits = logits + torch.einsum("bqhd,bkd->bhqk", q_rope.float(),
                                   k_rope.float())
    logits = logits * (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    kidx = torch.arange(t, device=x.device)
    if cache is not None:
        mask = kidx[None, None, None, :] <= cache_pos[:, None, None, None]
    else:
        mask = (kidx[None, :] <= torch.arange(s, device=x.device)[:, None]
                )[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(
        b, s, h * m.v_head_dim)
    return out @ p["w_o"], new_cache


def init_mla_cache(cfg, batch: int, max_len: int, dtype=None,
                   device: torch.device | str = "cuda") -> MLACache:
    m = cfg.mla
    dt = dtype or cfg.dtype
    return MLACache(
        kv_latent=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                              device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt,
                           device=device),
    )
