"""Spike-domain helper ops: merged spikes, input quantization, bit-planes,
sparsity statistics.

Each function computes what its namesake in the reference computes, in the
same order of float operations, so that results agree bit for bit.
"""

from __future__ import annotations

import torch


def merge_spikes(spikes_ts: torch.Tensor) -> torch.Tensor:
    """Merged-spike technique (paper §II-D2): sum (TS, ..., H) spike
    trains over TS; the merged value lies in {0, .., TS}."""
    return spikes_ts.sum(dim=0)


def merged_spike_fc(spikes_ts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FC layer with merged spikes: one matmul for all time steps."""
    return merge_spikes(spikes_ts) @ w


def quantize_input(x: torch.Tensor, bits: int = 8,
                   scale: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric fixed-point input quantization (paper: 8-bit inputs).

    Returns (q, scale).  ``round`` is half to even in both frameworks; the
    last line is the reference's straight-through form ``x/scale + (q -
    x/scale)`` (gradient 1 through ``x/scale``), which in float32 need not
    equal ``q`` where a value clips — it is kept so that the result
    matches the reference bit for bit.  ``qmax`` divides as a tensor on
    ``x``'s device: PyTorch divides a CUDA tensor by a host scalar as a
    product with its reciprocal, an ulp from the reference's scale.
    """
    qmax = 2.0 ** (bits - 1) - 1
    if scale is None:
        scale = torch.clamp(x.abs().max(), min=1e-8) / torch.full(
            (), qmax, dtype=x.dtype, device=x.device)
    xs = x / scale
    q = torch.clamp(torch.round(xs), -qmax - 1, qmax)
    return xs + (q - xs).detach(), scale


def bitplanes(q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Bit-plane expansion of integer-valued ``q``: (..., bits) in {0, 1}
    over the magnitude (the bit-serial input layer's convention)."""
    mag = q.abs().to(torch.int32)
    shifts = torch.arange(bits, dtype=torch.int32, device=q.device)
    return (mag.unsqueeze(-1) >> shifts) & 1


def input_bit_sparsity(q: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Fraction of zero bits in the magnitude of ``q`` (the bit-serial
    input layer's type-A zero skipping, paper Fig. 5a)."""
    return 1.0 - bitplanes(q, bits).to(torch.float32).mean()


def spike_sparsity(spikes: torch.Tensor) -> torch.Tensor:
    """Fraction of zero spikes (paper Fig. 18 reports 60-71%)."""
    return 1.0 - spikes.mean()
