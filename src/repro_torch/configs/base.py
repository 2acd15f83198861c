"""Config system: the architecture configs of the token LMs.

Every assigned architecture is a `ModelConfig`; names resolve through
`repro_torch.models.registry`.  The port's own copy of the reference's
`configs/base.py` (which imports `jax.numpy`): the same fields and
defaults, `dtype` a `torch.dtype`, and the grid of input shapes that
`launch/steps.py` `batch_shapes` reads (`ShapeConfig`, `LM_SHAPES`,
`shape_by_name`), and the cells the dry run skips (`LONG_CONTEXT_SKIP`,
`cell_is_runnable`).  Left out: `weight_bits`, read by neither package.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_impl: str = "dense_dispatch"  # 'dense_dispatch' (GShard) | 'ragged'
    group_size: int = 4096  # tokens per dispatch group (bounds dispatch tensor)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM recurrent-block parameters."""

    kind: str = "mamba2"  # 'mamba2' | 'xlstm'
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    # xlstm: positions of sLSTM blocks (others are mLSTM)
    slstm_layers: tuple[int, ...] = ()
    # recurrence execution: 'chunked' (parallel per-chunk, state materialised
    # only at chunk boundaries — §Perf hillclimb) or 'sequential' (baseline)
    scan_impl: str = "chunked"
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | ssm | hybrid | rsnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // num_heads
    # --- attention variants -------------------------------------------------
    attn_type: str = "full"  # 'full' | 'local_global' (gemma2 alternating)
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    norm_type: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    sandwich_norm: bool = False  # gemma2 post-norms
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    mlp_type: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu'
    # --- MoE ------------------------------------------------------------
    moe: MoEConfig | None = None
    dense_layers: int = 0  # leading dense layers (deepseek: 3, kimi: 1)
    dense_d_ff: int | None = None
    # --- MLA ------------------------------------------------------------
    mla: MLAConfig | None = None
    # --- encoder-decoder (whisper) ---------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of audio at 50 Hz after conv stub
    # --- ssm / hybrid -----------------------------------------------------
    ssm: SSMConfig | None = None
    attn_every: int = 0  # zamba2: shared attention block every k layers
    # --- frontend stubs ----------------------------------------------------
    frontend: str | None = None  # 'patch' (vlm) | 'audio'
    num_patch_tokens: int = 256  # internvl2 visual tokens per image
    # --- numerics / memory -------------------------------------------------
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: str = "full"  # activation checkpointing policy on the layer scan
    optimizer: str = "adamw"  # adamw | adamw8bit | adafactor
    # paper-technique toggle
    spiking: bool = False  # RSNN-ified recurrence (xlstm only)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over 16-way TP."""
        return (self.vocab_size + 255) // 256 * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; options: "
                   f"{[s.name for s in LM_SHAPES]}")


# Archs for which long_500k is skipped (pure full attention; see DESIGN.md
# §Arch-applicability). gemma2 runs it (alternating 4k sliding-window layers);
# xlstm/zamba2 run it (bounded recurrent state).
LONG_CONTEXT_SKIP = frozenset({
    "internvl2-26b", "yi-6b", "stablelm-3b", "gemma-7b", "whisper-base",
    "deepseek-v3-671b", "kimi-k2-1t-a32b",
})


def cell_is_runnable(arch: str, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch in LONG_CONTEXT_SKIP:
        return False, ("pure full-attention arch: 500k context needs "
                       "sub-quadratic attention (DESIGN.md)")
    return True, ""
