"""--arch resolution: name -> (ModelConfig, ModelAPI) + reduced smoke configs.

ModelAPI is the uniform interface the server uses:
  init(generator, device="cuda") -> params
  forward(params, batch, cache=None, mode="train") -> (logits, new_cache)
  init_cache(batch, max_len, device="cuda") -> cache
`batch` always carries 'tokens' (B, S); VLM adds 'patch_embeds' (the
stubbed frontend).  The reference's ``models/registry.py`` for the
decoder-LM family (dense, moe, vlm); the other families are not ported yet
and raise.  ``params_from_numpy`` / ``params_to_numpy`` carry a parameter
or cache tree between the reference's layout (numpy leaves) and the
port's (tensor leaves).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer


class ModelAPI(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., tuple[torch.Tensor, Any]]
    init_cache: Callable[..., Any]


def _lm_api(cfg: ModelConfig) -> ModelAPI:
    def fwd(params, batch, cache=None, mode="train"):
        return transformer.lm_forward(params, batch["tokens"], cfg,
                                      frontend_embeds=batch.get("patch_embeds"),
                                      cache=cache, mode=mode)

    def init(generator: torch.Generator, device="cuda"):
        return transformer.init_lm(generator, cfg, device)

    def init_cache(batch: int, max_len: int, device="cuda"):
        return transformer.init_decode_cache(cfg, batch, max_len, device)

    return ModelAPI(cfg=cfg, init=init, forward=fwd, init_cache=init_cache)


def _not_ported(what: str, item: str) -> Callable[[ModelConfig], ModelAPI]:
    def api(cfg: ModelConfig) -> ModelAPI:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family ({what}) is not ported "
            f"to repro_torch yet (ROADMAP.md, queue 1 item {item})")
    return api


_FAMILY_API = {
    "dense": _lm_api, "moe": _lm_api, "vlm": _lm_api,
    "audio": _not_ported("models/encdec.py", "4a"),
    "ssm": _not_ported("models/ssm.py, models/layers/xlstm.py", "4a"),
    "hybrid": _not_ported("models/hybrid.py, models/layers/mamba2.py", "4b"),
}


def get_model(arch: str, cfg: ModelConfig | None = None) -> ModelAPI:
    cfg = cfg or ALL_ARCHS[arch]
    return _FAMILY_API[cfg.family](cfg)


def list_archs() -> list[str]:
    return sorted(ALL_ARCHS)


# ---------------------------------------------------------------------------
# Weights across packages
# ---------------------------------------------------------------------------


def params_from_numpy(tree, device: torch.device | str,
                      dtype: torch.dtype | None = None):
    """The reference's tree with numpy leaves (``jax.tree.map(np.asarray,
    params)``) as the port's: the same dicts, lists, tuples and leaf names,
    ``torch.Tensor`` leaves on ``device``.  bf16 leaves (numpy's bfloat16
    extension type) cross as float32; ``dtype`` casts every floating leaf."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.kind not in "biuf":  # the bfloat16 extension type
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a)).to(device)  # a writable copy
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t

    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The inverse of ``params_from_numpy``: tensor leaves as numpy arrays
    on the host, bf16 as float32."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests (same family, tiny dims)
# ---------------------------------------------------------------------------


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink every axis while preserving the family's structure: layer
    alternation, MoE routing, MLA latents, shared blocks, frontends."""
    upd: dict[str, Any] = dict(
        num_layers=4 if cfg.attn_every or cfg.ssm else 3,
        d_model=64, num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=128, vocab_size=503, head_dim=16,
        dtype=torch.float32,
    )
    if cfg.num_kv_heads == cfg.num_heads:
        upd["num_kv_heads"] = 4
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                         d_ff=32, group_size=64)
        upd["dense_layers"] = min(cfg.dense_layers, 1)
        upd["dense_d_ff"] = 96
    if cfg.mla is not None:
        upd["mla"] = dataclasses.replace(cfg.mla, q_lora_rank=32,
                                         kv_lora_rank=16, qk_nope_head_dim=16,
                                         qk_rope_head_dim=8, v_head_dim=16)
    if cfg.encoder_layers:
        upd["encoder_layers"] = 2
        upd["encoder_seq"] = 12
        upd["num_layers"] = 2
    if cfg.ssm is not None and cfg.ssm.kind == "xlstm":
        upd["ssm"] = SSMConfig(kind="xlstm", slstm_layers=(1,))
        upd["num_layers"] = 3
        upd["head_dim"] = None
        upd["num_heads"] = 2
        upd["d_model"] = 64
    if cfg.ssm is not None and cfg.ssm.kind == "mamba2":
        upd["ssm"] = SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                               head_dim=16)
        upd["attn_every"] = 2 if cfg.attn_every else 0
        upd["num_layers"] = 5  # 2 groups of 2 + tail 1
    if cfg.sliding_window:
        upd["sliding_window"] = 8
    if cfg.frontend == "patch":
        upd["num_patch_tokens"] = 4
    return dataclasses.replace(cfg, **upd)
