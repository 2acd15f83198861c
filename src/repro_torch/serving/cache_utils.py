"""Cache capacity management: grow prefill caches to decode capacity.

Prefill returns caches sized exactly to the prompt; decode needs spare
rows.  `pad_cache` zero-pads every sequence-sized dim (leaves named like KV
caches) up to `max_len`, leaving recurrent states untouched.  The
reference's ``serving/cache_utils.py``: leaves are found by name through
the port's NamedTuples, dicts and lists, as ``tree_map_with_path`` finds
them.
"""

from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map_with_name


def pad_cache(cache, prompt_len: int, max_len: int):
    if max_len <= prompt_len:
        return cache

    def pad(name, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
            return leaf
        if name in ("k", "v"):
            d = leaf.ndim - 3  # (..., T, H, hd)
        elif name in ("kv_latent", "k_rope"):
            d = leaf.ndim - 2  # (..., T, r)
        else:
            return leaf  # recurrent states / pos / enc_out
        if leaf.shape[d] != prompt_len:
            return leaf
        shape = list(leaf.shape)
        shape[d] = max_len - prompt_len
        return torch.cat([leaf, leaf.new_zeros(shape)], dim=d)

    return tree_map_with_name(pad, cache)
