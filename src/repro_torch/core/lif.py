"""Leaky integrate-and-fire neuron (paper Eq. 2-3, Fig. 6).

    U[t][ts] = stimulus + beta * U[t][ts-1] * (1 - h[t][ts-1])
    h[t][ts] = 1  if U[t][ts] >= V_th else 0

with a learnable threshold V_th and decay beta (DIET-SNN) and a surrogate
gradient for the non-differentiable spike (``spike_fn``: the fast-sigmoid
``1 / (1 + slope |u - vth|)^2``).  ``init_lif`` makes the learnable
parameters at a requested beta and vth, ``lif_step`` runs one update.
An int4 deployment artifact carries the inference constants (beta, vth)
already resolved; a float artifact carries the learnable parameters in
their unconstrained form (``LIFParams``).  ``inference_constants`` turns
them into (beta, vth), rounded to powers of two on the hardware path
(paper Fig. 6) with straight-through gradients, with the reference's
formulas in the reference's order.  Transcendentals (sigmoid,
log-add-exp, log2) may round an ulp apart from the reference's, so the
constants agree within a few ulp, not bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.device import resolve_alloc_device


class LIFParams(NamedTuple):
    """Per-neuron learnable LIF parameters (unconstrained space)."""

    raw_beta: torch.Tensor  # beta = sigmoid(raw_beta) in (0, 1)
    raw_vth: torch.Tensor  # vth = softplus(raw_vth) > 0


class LIFState(NamedTuple):
    """Carried LIF state: membrane potential and previous spike."""

    u: torch.Tensor  # (B, H)
    spike: torch.Tensor  # (B, H)


def init_lif(num_neurons: int, beta_init: float = 0.9, vth_init: float = 1.0,
             dtype: torch.dtype = torch.float32,
             device: torch.device | str = "cuda") -> LIFParams:
    """Learnable LIF parameters at the requested beta and vth:
    ``raw_beta = logit(beta_init)``, ``raw_vth = softplus^-1(vth_init)``,
    computed in double precision and rounded once to ``dtype``, on
    ``device`` (``cuda`` unless the caller asks for ``cpu``; ``meta``:
    shapes only)."""
    device = resolve_alloc_device(device)
    raw_beta = math.log(beta_init / (1.0 - beta_init))
    raw_vth = math.log(math.expm1(vth_init))
    return LIFParams(
        raw_beta=torch.full((num_neurons,), raw_beta, dtype=dtype,
                            device=device),
        raw_vth=torch.full((num_neurons,), raw_vth, dtype=dtype,
                           device=device))


def init_lif_state(batch: int, num_neurons: int,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda") -> LIFState:
    """Zero LIF carries on ``device`` (``cuda`` unless the caller asks
    for ``cpu``; ``meta``: shapes only)."""
    device = resolve_alloc_device(device)
    return LIFState(
        u=torch.zeros((batch, num_neurons), dtype=dtype, device=device),
        spike=torch.zeros((batch, num_neurons), dtype=dtype, device=device))


def beta_of(params: LIFParams) -> torch.Tensor:
    return torch.sigmoid(params.raw_beta)


def vth_of(params: LIFParams) -> torch.Tensor:
    """softplus as the reference writes it, ``logaddexp(x, 0)`` (not
    ``F.softplus``, whose large-input branch returns x itself)."""
    x = params.raw_vth
    return torch.logaddexp(x, torch.zeros_like(x))


def inference_constants(params: LIFParams, hw_rounded: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Concrete (beta, vth) for inference; pow-2-rounded on the hw path."""
    beta, vth = beta_of(params), vth_of(params)
    if hw_rounded:
        beta, vth = round_beta_pow2(beta), round_vth_pow2(vth)
    return beta, vth


class _Spike(torch.autograd.Function):
    """Heaviside forward, fast-sigmoid surrogate backward (the reference's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, u, vth, slope):
        ctx.save_for_backward(u, vth)
        ctx.slope = slope
        return (u >= vth).to(u.dtype)

    @staticmethod
    def backward(ctx, g):
        u, vth = ctx.saved_tensors
        surr = 1.0 / torch.square(1.0 + ctx.slope * torch.abs(u - vth))
        du = g * surr
        # vth broadcasts over the batch: reduce its gradient to its shape
        dvth = -du
        if dvth.dim() > vth.dim():
            dvth = dvth.sum(dim=tuple(range(dvth.dim() - vth.dim())))
        return du, dvth, None


def spike_fn(u: torch.Tensor, vth: torch.Tensor,
             slope: float = 25.0) -> torch.Tensor:
    """Heaviside spike with a fast-sigmoid surrogate gradient.

    Forward: h = 1[u >= vth].  Backward: dh/du = 1 / (1 + slope |u - vth|)^2
    (snnTorch-style fast sigmoid), dh/dvth = -dh/du summed down to vth's
    shape; ``slope`` takes no gradient.
    """
    return _Spike.apply(u, vth, slope)


def lif_step(params: LIFParams, state: LIFState, stimulus: torch.Tensor,
             slope: float = 25.0, hw_rounded: bool = False
             ) -> tuple[LIFState, torch.Tensor]:
    """One LIF update (Eq. 2-3): returns (new_state, spike).

    ``hw_rounded=True`` uses power-of-two-rounded beta / vth, as the
    shift-add inference hardware does (paper §III-C), with straight-through
    gradients.  The reset term carries the previous spike's gradient, and
    so does the recurrent spike that the next frame reads, as in the
    reference: nothing here is detached.
    """
    beta, vth = inference_constants(params, hw_rounded)
    # leak of the previous membrane, reset to zero where the previous
    # spike fired (the Fig. 6 multiplexer)
    u = stimulus + beta * state.u * (1.0 - state.spike)
    h = spike_fn(u, vth, slope)
    return LIFState(u=u, spike=h), h


def round_beta_pow2(beta: torch.Tensor, max_shift: int = 5) -> torch.Tensor:
    """Round beta in (0, 1) to the nearest of {2^-k} U {1 - 2^-k},
    k = 1..max_shift (a shift, or a shift and a subtract); a tie takes the
    first candidate in that order.  Straight-through: the value is the
    reference's ``beta + (rounded - beta)``, the gradient 1."""
    ks = torch.arange(1, max_shift + 1, dtype=beta.dtype, device=beta.device)
    cands = torch.cat([torch.exp2(-ks), 1.0 - torch.exp2(-ks)])
    idx = torch.argmin((beta.unsqueeze(-1) - cands).abs(), dim=-1)
    rounded = cands[idx]
    return beta + (rounded - beta).detach()


def round_vth_pow2(vth: torch.Tensor, min_exp: int = -4,
                   max_exp: int = 4) -> torch.Tensor:
    """Round vth to the nearest power of two in [2^min_exp, 2^max_exp]
    (``round`` is half to even, as in the reference); straight-through,
    as ``round_beta_pow2``."""
    exps = torch.clamp(torch.round(torch.log2(torch.clamp(vth, min=1e-8))),
                       min_exp, max_exp)
    rounded = torch.exp2(exps)
    return vth + (rounded - vth).detach()
