"""The paper's recurrent spiking network: configuration, carried state, the
float golden model and its training loss.

Two recurrent spiking layers and a merged-spike FC readout (paper Fig. 1,
Table I).  ``init_params`` draws a parameter dict from an explicit
``torch.Generator``.  ``frame_step`` and ``forward`` run the float model over a
parameter dict (``l0_wx``, ``l0_wh``, ``l1_wx``, ``l1_wh``, ``fc_w`` and
``lif0``/``lif1`` as ``LIFParams``) with plain PyTorch, on the device the
tensors lie on; they are the reference's golden model, operation for
operation, and differentiable: ``loss_fn`` back-propagates through every
frame, the spikes by the surrogate gradient of ``lif.spike_fn``.  The
served frame step lives in ``serving/stream.py``, composed from the op
table of ``serving/backends.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import lif as lif_lib
from repro_torch.core import spike_ops
from repro_torch.core.lif import LIFParams, LIFState


@dataclasses.dataclass(frozen=True)
class RSNNConfig:
    """Paper model hyper-parameters (Table I).  Always float32."""

    input_dim: int = 40
    hidden_dim: int = 256  # 256 baseline, 128 after structured pruning
    fc_dim: int = 1920
    num_ts: int = 2  # SNN time steps
    beta_init: float = 0.9
    vth_init: float = 1.0
    surrogate_slope: float = 25.0
    merged_spike: bool = True
    input_bits: int = 8  # 8-bit fixed-point input features
    hw_rounded_lif: bool = False  # power-of-2 beta/vth (inference hardware)

    @property
    def layer_shapes(self) -> dict[str, tuple[int, int]]:
        h = self.hidden_dim
        return {
            "l0_wx": (self.input_dim, h),
            "l0_wh": (h, h),
            "l1_wx": (h, h),
            "l1_wh": (h, h),
            "fc_w": (h, self.fc_dim),
        }

    @property
    def num_params(self) -> int:
        return sum(a * b for a, b in self.layer_shapes.values())


class RSNNState(NamedTuple):
    """Carried across frames: per-ts recurrent spikes + LIF membrane chain."""

    h0: torch.Tensor  # (TS, B, H) L0 spike outputs of the previous frame
    h1: torch.Tensor  # (TS, B, H) L1 spike outputs of the previous frame
    lif0: LIFState  # membrane chain of L0 (last ts of the previous frame)
    lif1: LIFState


def init_params(generator: torch.Generator, cfg: RSNNConfig) -> dict:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, PyTorch-RNN style,
    drawn from ``generator`` on its device, and the LIF parameters at
    ``cfg``'s beta and vth.  The values are not the reference's, whose
    draws come from a JAX key."""
    device = generator.device
    params: dict = {}
    for name, shape in cfg.layer_shapes.items():
        bound = 1.0 / math.sqrt(shape[0])
        params[name] = torch.empty(shape, dtype=torch.float32,
                                   device=device).uniform_(
            -bound, bound, generator=generator)
    for i in (0, 1):
        params[f"lif{i}"] = lif_lib.init_lif(cfg.hidden_dim, cfg.beta_init,
                                             cfg.vth_init, device=device)
    return params


def init_state(cfg: RSNNConfig, batch: int, num_ts: int | None = None, *,
               device: torch.device | str) -> RSNNState:
    ts = num_ts or cfg.num_ts
    h = cfg.hidden_dim

    # separate tensors: the slot loop writes its state in place
    def z():
        return torch.zeros((ts, batch, h), dtype=torch.float32, device=device)

    return RSNNState(h0=z(), h1=z(),
                     lif0=lif_lib.init_lif_state(batch, h, device=device),
                     lif1=lif_lib.init_lif_state(batch, h, device=device))


def _lif_chain(lif_params: LIFParams, state: LIFState, stim_ts: torch.Tensor,
               cfg: RSNNConfig) -> tuple[LIFState, torch.Tensor]:
    """Sequential membrane chain over the TS axis (paper Eq. 2-3).
    stim_ts: (TS, B, H)."""
    spikes = []
    for ts in range(stim_ts.shape[0]):
        state, h = lif_lib.lif_step(lif_params, state, stim_ts[ts],
                                    cfg.surrogate_slope, cfg.hw_rounded_lif)
        spikes.append(h)
    return state, torch.stack(spikes)


def frame_step(params: dict, state: RSNNState, x_t: torch.Tensor,
               cfg: RSNNConfig) -> tuple[RSNNState, tuple[torch.Tensor, dict]]:
    """One 10-ms frame through the float RSNN.  x_t: (B, input_dim),
    already 8-bit quantized.  Returns (state, (logits (B, fc_dim), aux))."""
    # L0: feed-forward stimulus once, shared across time steps; the
    # recurrent product over all TS at once
    ff0 = x_t @ params["l0_wx"]
    rec0 = state.h0 @ params["l0_wh"]
    lif0, s0 = _lif_chain(params["lif0"], state.lif0, ff0.unsqueeze(0) + rec0,
                          cfg)
    # L1: feed-forward from the per-ts L0 spikes
    stim1 = s0 @ params["l1_wx"] + state.h1 @ params["l1_wh"]
    lif1, s1 = _lif_chain(params["lif1"], state.lif1, stim1, cfg)
    if cfg.merged_spike:
        logits = spike_ops.merged_spike_fc(s1, params["fc_w"])
    else:
        logits = (s1 @ params["fc_w"]).sum(dim=0)
    aux = {
        "spike_rate_l0": s0.mean(dim=(1, 2)),  # per-ts firing rate
        "spike_rate_l1": s1.mean(dim=(1, 2)),
        "union_rate_l1": s1.amax(dim=0).mean(),
    }
    return RSNNState(h0=s0, h1=s1, lif0=lif0, lif1=lif1), (logits, aux)


def forward(params: dict, x: torch.Tensor, cfg: RSNNConfig,
            state: RSNNState | None = None, num_ts: int | None = None
            ) -> tuple[torch.Tensor, RSNNState, dict]:
    """The float RSNN over a frame sequence on ``x``'s device.  x: (B, T,
    input_dim) raw features, quantized to ``cfg.input_bits`` with their
    own max-abs scale.  Returns (logits (B, T, fc_dim), state, aux: the
    per-frame rates averaged over frames, and ``input_bit_sparsity``).
    Differentiable in the parameters: ``loss_fn`` trains through it."""
    b = x.shape[0]
    if state is None:
        state = init_state(cfg, b, num_ts, device=x.device)
    xq, _ = spike_ops.quantize_input(x, cfg.input_bits)
    logits, auxes = [], []
    for t in range(xq.shape[1]):
        state, (lg, aux) = frame_step(params, state, xq[:, t], cfg)
        logits.append(lg)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]).mean(dim=0) for k in auxes[0]}
    aux["input_bit_sparsity"] = spike_ops.input_bit_sparsity(xq,
                                                             cfg.input_bits)
    return torch.stack(logits, dim=1), state, aux


def loss_fn(params: dict, batch: dict, cfg: RSNNConfig,
            materialize: Callable[[dict], dict] | None = None,
            num_ts: int | None = None) -> tuple[torch.Tensor, dict]:
    """Frame-level cross entropy (paper §IV-A).  batch: ``features`` (B, T,
    input_dim), ``labels`` (B, T) and an optional 0/1 ``mask`` (B, T) of
    the frames that count.

    ``materialize`` lets the compression pipeline rewrite weights (pruning
    masks, fake-quant) before the forward pass.  Returns (loss, aux: the
    forward's rates, ``accuracy`` and ``frame_error_rate``).
    """
    p = materialize(params) if materialize is not None else params
    logits, _, aux = forward(p, batch["features"], cfg, num_ts=num_ts)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    # a negative label counts from the end, as the reference's
    # take_along_axis reads it
    idx = torch.where(labels < 0, labels + logp.shape[-1], labels)
    nll = -torch.gather(logp, -1, idx.unsqueeze(-1)).squeeze(-1)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    preds = logits.argmax(dim=-1)
    acc = ((preds == labels) * mask).sum() / denom
    aux = dict(aux, accuracy=acc, frame_error_rate=1.0 - acc)
    return loss, aux
