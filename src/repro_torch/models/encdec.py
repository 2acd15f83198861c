"""Whisper-style encoder-decoder (audio frontend stubbed).

The batch supplies precomputed frame embeddings (B, encoder_seq, D), the
conv1d x 2 + GELU frontend's output, so the transformer backbone is what
runs.

The reference's ``models/encdec.py`` in plain PyTorch: the stacked
encoder and decoder layers keep their leading layer axis and a Python loop
over it replaces ``jax.lax.scan``.  ``cfg.remat == "full"`` checkpoints
each decoder layer in train mode (``torch.utils.checkpoint`` where the
reference calls ``jax.checkpoint``; the encoder is not checkpointed, in
the reference either).
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


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) float32 absolute positions, computed in float32
    as the reference computes them."""
    f32 = torch.float32
    lds = torch.log(torch.tensor(10000.0, dtype=f32, device=device)) \
        / (channels // 2 - 1)
    inv = torch.exp(-lds * torch.arange(channels // 2, dtype=f32,
                                        device=device))
    t = torch.arange(length, dtype=f32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def init_enc_layer(init: basic.ParamInit, cfg) -> dict:
    return {
        "attn_norm": basic.init_norm(init, cfg, cfg.d_model),
        "attn": attn_lib.init_attn(init, cfg),
        "mlp_norm": basic.init_norm(init, cfg, cfg.d_model),
        "mlp": basic.init_mlp(init, cfg, cfg.d_model, cfg.d_ff),
    }


def init_dec_layer(init: basic.ParamInit, cfg) -> dict:
    return {
        "attn_norm": basic.init_norm(init, cfg, cfg.d_model),
        "attn": attn_lib.init_attn(init, cfg),
        "cross_norm": basic.init_norm(init, cfg, cfg.d_model),
        "cross": attn_lib.init_attn(init, cfg),
        "mlp_norm": basic.init_norm(init, cfg, cfg.d_model),
        "mlp": basic.init_mlp(init, cfg, cfg.d_model, cfg.d_ff),
    }


def init_encdec(generator: torch.Generator, cfg,
                device: torch.device | str = "cuda",
                max_dec_len: int = 4096) -> dict:
    """The parameter tree, drawn from ``generator`` (``basic.ParamInit``);
    ``device="meta"`` gives shapes and dtypes only."""
    init = basic.ParamInit(generator, device)
    return {
        "embed": basic.init_embedding(init, cfg),
        "dec_pos": init.normal((max_dec_len, cfg.d_model), cfg.dtype, 0.01),
        "enc_layers": init_enc_layer(init.stacked(cfg.encoder_layers), cfg),
        "dec_layers": init_dec_layer(init.stacked(cfg.num_layers), cfg),
        "enc_norm": basic.init_norm(init, cfg, cfg.d_model),
        "final_norm": basic.init_norm(init, cfg, cfg.d_model),
    }


def encode(params, frames: torch.Tensor, cfg) -> torch.Tensor:
    """frames: (B, T_enc, D) stub frontend output."""
    x = frames.to(cfg.dtype) + _sinusoids(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None].expand(b, t)
    for lp in tree_unstack(params["enc_layers"]):
        h = basic.apply_norm(x, lp["attn_norm"], cfg)
        # bidirectional: no mask, no rope (whisper uses abs pos)
        a, _ = attn_lib.attention(h, lp["attn"], cfg, positions, rope=False,
                                  kv_x=h)
        x = x + a
        h = basic.apply_norm(x, lp["mlp_norm"], cfg)
        x = x + basic.mlp(h, lp["mlp"], cfg)
    return basic.apply_norm(x, params["enc_norm"], cfg)


class EncDecCache(NamedTuple):
    self_caches: Any  # stacked per-decoder-layer KV caches
    enc_out: torch.Tensor  # (B, T_enc, D)
    pos: torch.Tensor


def decode_layer(x, lp, cfg, positions, enc_out, cache, cache_pos,
                 return_kv=False):
    h = basic.apply_norm(x, lp["attn_norm"], cfg)
    a, new_cache = attn_lib.attention(h, lp["attn"], cfg, positions,
                                      rope=False, cache=cache,
                                      cache_pos=cache_pos,
                                      return_kv=return_kv)
    x = x + a
    h = basic.apply_norm(x, lp["cross_norm"], cfg)
    c, _ = attn_lib.attention(h, lp["cross"], cfg, positions, rope=False,
                              kv_x=enc_out)
    x = x + c
    h = basic.apply_norm(x, lp["mlp_norm"], cfg)
    return x + basic.mlp(h, lp["mlp"], cfg), new_cache


def encdec_forward(params, tokens, cfg, frames=None, enc_out=None,
                   cache: EncDecCache | None = None, mode: str = "train"):
    """Train/prefill: frames given, cache None. Decode: cache carries
    enc_out."""
    b, s = tokens.shape
    mode = "decode" if cache is not None else mode
    prefill = mode == "prefill"
    if cache is not None:
        enc_out = cache.enc_out
        positions = cache.pos[:, None]
        cache_pos = cache.pos
        row = cache.pos.clamp(0, params["dec_pos"].shape[0] - 1)
        pos_emb = params["dec_pos"][row.long()][:, None]
    else:
        if enc_out is None:
            enc_out = encode(params, frames, cfg)
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device)[None].expand(b, s)
        cache_pos = None
        pos_emb = params["dec_pos"][None, :s]

    x = basic.embed_tokens(tokens, params["embed"], cfg) + pos_emb

    fwd = decode_layer
    if cfg.remat == "full" and mode == "train":
        fwd = functools.partial(checkpoint, decode_layer, use_reentrant=False)
    layer_caches = []
    for i, lp in enumerate(tree_unstack(params["dec_layers"])):
        c = tree_index(cache.self_caches, i) if cache is not None else None
        x, nc = fwd(x, lp, cfg, positions, enc_out, c, cache_pos,
                    return_kv=prefill)
        layer_caches.append(nc)

    if cache is not None:
        new_cache = EncDecCache(self_caches=tree_stack(layer_caches),
                                enc_out=enc_out, pos=cache.pos + 1)
    elif prefill:
        new_cache = EncDecCache(self_caches=tree_stack(layer_caches),
                                enc_out=enc_out,
                                pos=torch.full((b,), s, dtype=torch.int32,
                                               device=x.device))
    else:
        new_cache = None

    if prefill:
        x = x[:, -1:]
    x = basic.apply_norm(x, params["final_norm"], cfg)
    return basic.unembed(x, params["embed"], cfg), new_cache


def init_encdec_cache(cfg, batch: int, max_len: int,
                      device: torch.device | str = "cuda") -> EncDecCache:
    device = resolve_alloc_device(device)  # meta: shapes only
    one = attn_lib.init_kv_cache(cfg, batch, max_len, device=device)
    return EncDecCache(
        self_caches=tree_map(
            lambda x: x.new_zeros((cfg.num_layers, *x.shape)), one),
        enc_out=torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                            dtype=cfg.dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )
