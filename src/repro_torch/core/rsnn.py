"""The paper's recurrent spiking network: configuration and carried state.

Two recurrent spiking layers and a merged-spike FC readout (paper Fig. 1,
Table I).  The frame step itself lives in ``serving/stream.py``, composed
from the op table of ``serving/backends.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.lif import LIFState


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


class RSNNState(NamedTuple):
    """Carried across frames: per-ts recurrent spikes + LIF membrane chain."""

    h0: torch.Tensor  # (TS, B, H) L0 spike outputs of the previous frame
    h1: torch.Tensor  # (TS, B, H) L1 spike outputs of the previous frame
    lif0: LIFState  # membrane chain of L0 (last ts of the previous frame)
    lif1: LIFState


def init_state(cfg: RSNNConfig, batch: int, num_ts: int | None = None, *,
               device: torch.device | str) -> RSNNState:
    ts = num_ts or cfg.num_ts
    h = cfg.hidden_dim

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return RSNNState(h0=z(ts, batch, h), h1=z(ts, batch, h),
                     lif0=LIFState(u=z(batch, h), spike=z(batch, h)),
                     lif1=LIFState(u=z(batch, h), spike=z(batch, h)))
