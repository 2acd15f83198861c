"""The 10 assigned token-LM architectures as ModelConfigs (the paper's own
RSNN is ``configs/rsnn_timit.py``).

Sources are the public configs cited in the assignment; [unverified] entries
follow the assignment's stated dimensions.  The port's copy of the
reference's ``configs/archs.py``, number for number.
"""

from __future__ import annotations

from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

INTERNVL2_26B = ModelConfig(
    # InternViT-6B frontend (stubbed patch embeddings) + InternLM2-20B LM
    # backbone [arXiv:2404.16821].
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, rope_theta=1_000_000.0,
    mlp_type="swiglu", frontend="patch", num_patch_tokens=256,
    optimizer="adamw8bit",
)

GEMMA2_2B = ModelConfig(
    # [arXiv:2408.00118]: alternating local(4096)/global attention, GeGLU,
    # logit softcaps, sandwich norms, tied embeddings, head_dim 256.
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000, attn_type="local_global",
    sliding_window=4096, attn_logit_softcap=50.0, final_logit_softcap=30.0,
    mlp_type="geglu", sandwich_norm=True, embed_scale=True, tie_embeddings=True,
)

YI_6B = ModelConfig(
    # [arXiv:2403.04652]: llama-arch GQA.
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000, rope_theta=5_000_000.0, mlp_type="swiglu",
)

STABLELM_3B = ModelConfig(
    # [hf:stabilityai/stablelm; unverified]: MHA, partial rotary, LayerNorm.
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=6912, vocab_size=50304, rotary_pct=0.25, norm_type="layernorm",
    mlp_type="swiglu",
)

GEMMA_7B = ModelConfig(
    # [arXiv:2403.08295]: GeGLU, head_dim 256, tied embeddings.
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, mlp_type="geglu", embed_scale=True,
    tie_embeddings=True,
)

WHISPER_BASE = ModelConfig(
    # [arXiv:2212.04356; unverified]: enc-dec, conv frontend stubbed.
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, encoder_seq=1500,
    d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=51865,
    norm_type="layernorm", mlp_type="gelu", tie_embeddings=True,
)

DEEPSEEK_V3_671B = ModelConfig(
    # [arXiv:2412.19437]: MLA, 1 shared + 256 routed top-8, 3 dense layers.
    # (MTP head not modelled; see DESIGN.md.)
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=2048, vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff=2048, num_shared_experts=1,
                  capacity_factor=1.25, group_size=512),
    dense_layers=3, dense_d_ff=18432,
    optimizer="adafactor",
)

KIMI_K2_1T = ModelConfig(
    # [arXiv:2501.kimi2; unverified]: DeepSeek-V3-family MLA MoE, 384 experts.
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=384, top_k=8, d_ff=2048, num_shared_experts=1,
                  capacity_factor=1.25, group_size=512),
    dense_layers=1, dense_d_ff=18432,
    optimizer="adafactor",
)

XLSTM_350M = ModelConfig(
    # [arXiv:2405.04517; unverified]: sLSTM + mLSTM blocks (7:1 -> 3 sLSTM).
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    ssm=SSMConfig(kind="xlstm", slstm_layers=(3, 11, 19)),
    remat="none",
)

ZAMBA2_7B = ModelConfig(
    # [arXiv:2411.15242; unverified]: Mamba2 backbone + shared attn block.
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2, head_dim=64),
    attn_every=6,
)

ALL_ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        INTERNVL2_26B, GEMMA2_2B, YI_6B, STABLELM_3B, GEMMA_7B, WHISPER_BASE,
        DEEPSEEK_V3_671B, KIMI_K2_1T, XLSTM_350M, ZAMBA2_7B,
    ]
}
