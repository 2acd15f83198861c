"""Shared building blocks of the token LMs: norms, RoPE, MLPs, embeddings,
the frontend splice, and ``ParamInit``, which draws a parameter tree.

Plain functions on tensors, operation for operation the reference's
``models/layers/basic.py``: norms in float32 inside, RoPE angles in
float32, split-half rotation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_alloc_device


class ParamInit:
    """Draws the random init of a parameter tree.

    Normal leaves come from ``generator`` on its own device and are moved
    to ``device``; ``device="meta"`` allocates nothing (shapes and dtypes
    only, the port's ``jax.eval_shape``).  ``lead`` prefixes every leaf's
    shape: ``stacked(n)`` gives the leading layer axis of the stacked
    layers, where the reference ``vmap``s its init over split keys.  The
    values are not the reference's, whose draws come from a JAX key."""

    def __init__(self, generator: torch.Generator,
                 device: torch.device | str = "cuda", lead: tuple = ()):
        self.device = resolve_alloc_device(device)
        self.generator = generator
        self.lead = tuple(lead)

    def stacked(self, n: int) -> ParamInit:
        return ParamInit(self.generator, self.device, (n, *self.lead))

    def normal(self, shape: tuple, dtype: torch.dtype,
               scale: float) -> torch.Tensor:
        """``normal(shape) * scale`` in ``dtype``, as the reference's
        ``jax.random.normal(key, shape, dtype) * scale``."""
        shape = (*self.lead, *shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, dtype=dtype,
                        device=self.generator.device)
        return x.mul_(scale).to(self.device)

    def zeros(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros((*self.lead, *shape), dtype=dtype,
                           device=self.device)

    def ones(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones((*self.lead, *shape), dtype=dtype,
                          device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            plus_one: bool = True) -> torch.Tensor:
    """RMSNorm in fp32 (gemma-style (1+scale) when plus_one)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if plus_one else scale.float()
    return (x * w).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def init_norm(init: ParamInit, cfg, d: int) -> dict:
    if cfg.norm_type == "layernorm":
        return {"scale": init.ones((d,), cfg.dtype),
                "bias": init.zeros((d,), cfg.dtype)}
    return {"scale": init.zeros((d,), cfg.dtype)}  # (1+scale) convention


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, rotary_pct: float = 1.0,
                     device=None) -> tuple[int, torch.Tensor]:
    """Returns (rot_dim, inv_freq (rot_dim//2,))."""
    rot_dim = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return rot_dim, 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Partial rotary supported:
    the first ``rot_dim`` features rotate (split-half), the rest pass."""
    hd = x.shape[-1]
    rot_dim, inv_freq = rope_frequencies(hd, theta, rotary_pct, x.device)
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    ang = positions.float()[..., None] * inv_freq  # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(init: ParamInit, cfg, d_model: int, d_ff: int) -> dict:
    s_in = d_model ** -0.5
    s_out = d_ff ** -0.5
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": init.normal((d_model, d_ff), cfg.dtype, s_in),
            "w_up": init.normal((d_model, d_ff), cfg.dtype, s_in),
            "w_down": init.normal((d_ff, d_model), cfg.dtype, s_out),
        }
    return {
        "w_up": init.normal((d_model, d_ff), cfg.dtype, s_in),
        "b_up": init.zeros((d_ff,), cfg.dtype),
        "w_down": init.normal((d_ff, d_model), cfg.dtype, s_out),
        "b_down": init.zeros((d_model,), cfg.dtype),
    }


def mlp(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if cfg.mlp_type == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh")
                * (x @ p["w_up"])) @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# Embeddings + frontend stubs
# ---------------------------------------------------------------------------


def init_embedding(init: ParamInit, cfg) -> dict:
    v = cfg.padded_vocab
    p = {"tok": init.normal((v, cfg.d_model), cfg.dtype, 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = init.normal((cfg.d_model, v), cfg.dtype,
                                   cfg.d_model ** -0.5)
    return p


def embed_tokens(tokens: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    x = p["tok"][tokens]
    if cfg.embed_scale:
        # the scale is rounded to x's dtype first, as the reference's
        # jnp.asarray(sqrt(d), x.dtype): sqrt(3072) = 55.43 is 55.5 in bf16
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def unembed(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = x @ w
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def splice_frontend_embeddings(x_tok: torch.Tensor,
                               frontend_embeds: torch.Tensor) -> torch.Tensor:
    """VLM/audio stub: prepend precomputed modality embeddings to the token
    embeddings, preserving total sequence length (the first N token slots are
    image/audio placeholder positions, as in InternVL chat templates)."""
    n = frontend_embeds.shape[1]
    return torch.cat([frontend_embeds.to(x_tok.dtype), x_tok[:, n:]], dim=1)
