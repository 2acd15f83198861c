"""Mixture-of-Experts layer (DeepSeek-V3 / Kimi-K2 family).

Baseline routing is GShard-style capacity-factor dispatch realised as two
einsums against a (tokens, E, C) combine tensor, built per token *group* so
the dispatch tensor stays bounded.  The 'ragged' implementation (tokens
sorted by expert, one product a group of rows) removes the dispatch-einsum
FLOP overhead and drops no token.

The reference's ``models/layers/moe.py`` in plain PyTorch: the router in
float32, slot-major capacity priority, gates renormalised with
``max(sum, 1e-9)``.  ``jax.lax.ragged_dot`` becomes ``_ragged_dot``, one
``torch.matmul`` for each expert's contiguous rows.  The reference's
expert-parallel sharding constraints are the identity on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import ParamInit


def init_moe(init: ParamInit, cfg) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.num_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": init.normal((d, e), torch.float32, s_in),
        "w_gate": init.normal((e, d, f), cfg.dtype, s_in),
        "w_up": init.normal((e, d, f), cfg.dtype, s_in),
        "w_down": init.normal((e, f, d), cfg.dtype, s_out),
    }
    if m.num_shared_experts:
        fs = m.d_ff * m.num_shared_experts
        p["shared"] = {
            "w_gate": init.normal((d, fs), cfg.dtype, s_in),
            "w_up": init.normal((d, fs), cfg.dtype, s_in),
            "w_down": init.normal((fs, d), cfg.dtype, fs ** -0.5),
        }
    return p


def _top_k_gates(probs: torch.Tensor, k: int):
    """The k largest router probabilities, descending (``torch.topk``, as
    ``jax.lax.top_k``), renormalised to sum to one.  The two break ties
    alike only by index, and ties have measure zero at float router
    weights."""
    gate_vals, idx = torch.topk(probs, k, dim=-1)
    return gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def _group_dispatch(probs: torch.Tensor, k: int, capacity: int
                    ) -> torch.Tensor:
    """GShard dispatch for each token group. probs: (N, G, E) fp32 (the
    reference ``vmap``s over the N groups).

    Returns combine (N, G, E, C) fp32."""
    n, g, e = probs.shape
    gate_vals, idx = _top_k_gates(probs, k)  # (N, G, k)
    # jax.nn.one_hot's iota compare (F.one_hot checks the indices' range
    # first on a device with data, so that its ops differ from meta's)
    experts = torch.arange(e, device=probs.device)
    onehot = (idx[..., None] == experts).float()  # (N, G, k, E)
    # Slot-major priority: all tokens' slot-0 choices first (GShard).
    slot_major = onehot.transpose(1, 2).reshape(n, k * g, e)
    pos = slot_major.cumsum(1) - slot_major  # position within expert
    keep = (pos < capacity) * slot_major
    slots = torch.arange(capacity, dtype=torch.float32, device=probs.device)
    pos_c = (pos[..., None] == slots).float() * keep[..., None]
    pos_c = pos_c.reshape(n, k, g, e, capacity).transpose(1, 2)
    return torch.einsum("ngk,ngkec->ngec", gate_vals, pos_c)


def _shared_experts(x: torch.Tensor, sp: dict) -> torch.Tensor:
    return (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]


def moe_layer(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). Dense-dispatch GShard implementation."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = x.reshape(-1, d)
    n_tok = tokens.shape[0]
    g = min(m.group_size, n_tok)
    if n_tok % g:
        raise ValueError(f"{n_tok} tokens not divisible by group {g}")
    n_groups = n_tok // g
    capacity = max(int(g * k / e * m.capacity_factor), 4)

    probs = torch.softmax(tokens.float() @ p["router"], dim=-1)
    combine = _group_dispatch(probs.reshape(n_groups, g, e), k, capacity)
    dispatch = (combine > 0).to(x.dtype)

    xg = tokens.reshape(n_groups, g, d)
    expert_in = torch.einsum("ngec,ngd->necd", dispatch, xg)
    # the expert products as one matmul batched over E, the weights read
    # as stored: (E, N*C, D) @ (E, D, F)
    xe = expert_in.transpose(0, 1).reshape(e, n_groups * capacity, d)
    h = F.silu(xe @ p["w_gate"]) * (xe @ p["w_up"])
    expert_out = (h @ p["w_down"]).reshape(e, n_groups, capacity, d)
    out = torch.einsum("ngec,necd->ngd", combine.to(x.dtype),
                       expert_out.transpose(0, 1))
    out = out.reshape(b, s, d)

    if m.num_shared_experts:
        out = out + _shared_experts(x, p["shared"])
    return out


# ---------------------------------------------------------------------------
# Ragged (dropless) implementation
# ---------------------------------------------------------------------------


def _ragged_dot(xs: torch.Tensor, w: torch.Tensor, sizes: list[int]
                ) -> torch.Tensor:
    """``jax.lax.ragged_dot``: rows of ``xs`` in consecutive groups of
    ``sizes``, group i times ``w[i]``; differentiable (one product a
    non-empty group, joined; ``w``'s gradient one stack of the
    experts')."""
    parts, start = [], 0
    for wi, n in zip(w.unbind(0), sizes):
        if n:
            parts.append(xs[start:start + n] @ wi)
            start += n
    return torch.cat(parts)


def _even_sizes(rows: int, e: int) -> list[int]:
    """``rows`` split as evenly as it goes over ``e`` groups, the
    remainder one row each to the first groups."""
    q, r = divmod(rows, e)
    return [q + 1] * r + [q] * (e - r)


def moe_layer_ragged(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    """Sort tokens by expert and run one product a group of rows — no
    dispatch-einsum FLOPs, no capacity drops. Used when
    cfg.moe.router_impl == 'ragged'.

    On ``meta`` tensors (the dry run) there is no routing to count, so the
    N k routed rows are split evenly over the E experts
    (``_even_sizes``).  ``_ragged_dot`` does 2 rows D F FLOPs however the
    rows split, so a trace counts the FLOPs exactly; its bytes differ from
    a real routing's only by the weights of the experts that routing
    leaves empty (and by the routing count, which ``meta`` skips).  On
    the CPU and the card the sizes are the data's own."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]

    probs = torch.softmax(tokens.float() @ p["router"], dim=-1)
    gate_vals, idx = _top_k_gates(probs, k)  # (N, k)

    flat_expert = idx.reshape(-1)  # (N*k,)
    order = torch.argsort(flat_expert, stable=True)  # as jnp.argsort
    inv_order = torch.argsort(order, stable=True)
    xs = tokens.repeat_interleave(k, dim=0)[order]
    # the group sizes steer the host's loop: one read of e counts a layer
    if x.device.type == "meta":
        sizes = _even_sizes(flat_expert.shape[0], e)
    else:
        sizes = torch.bincount(flat_expert, minlength=e).tolist()

    h = F.silu(_ragged_dot(xs, p["w_gate"], sizes)) * \
        _ragged_dot(xs, p["w_up"], sizes)
    ys = _ragged_dot(h, p["w_down"], sizes)

    ys = ys[inv_order].reshape(n, k, d)
    out = torch.einsum("nk,nkd->nd", gate_vals.to(x.dtype), ys)
    out = out.reshape(b, s, d)

    if m.num_shared_experts:
        out = out + _shared_experts(x, p["shared"])
    return out


def moe_apply(x, p, cfg):
    if cfg.moe.router_impl == "ragged":
        return moe_layer_ragged(x, p, cfg)
    return moe_layer(x, p, cfg)
