"""Leaky integrate-and-fire state (paper Eq. 2-3), inference side only.

An int4 deployment artifact carries the inference constants (beta, vth)
already resolved, so the serving path needs only the carried state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LIFState(NamedTuple):
    """Carried LIF state: membrane potential and previous spike."""

    u: torch.Tensor  # (B, H)
    spike: torch.Tensor  # (B, H)
