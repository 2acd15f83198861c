"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, in the kernel's order of
the float operations that are not exact, so that:

  * on a CPU tensor, ``kernels/ops.py`` runs these instead of the kernel;
  * on the card, ``chip_smoke.py`` holds each kernel against them;
  * on the CPU, the tests hold them against the reference's Pallas kernels
    in interpret mode.

The int4 products (``int4_matmul_ref``, ``merged_spike_fc_ref``,
``sparse_fc_ref``) accumulate integer-valued products and apply the
per-channel scale once at the end, as the Pallas kernels do: with 8-bit
inputs or spikes in {0..TS} every partial sum is an integer below 2**24,
so any summation order gives the same float and the results agree bit for
bit.  ``rsnn_cell_ref`` sums float32 dequantized weights, whose result
depends on the order; it agrees within a stated tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.core.compression.quantization import unpack_int4


def rsnn_cell_ref(stim_base: torch.Tensor, s_prev: torch.Tensor,
                  w: torch.Tensor, u0: torch.Tensor, h0: torch.Tensor,
                  beta: torch.Tensor, vth: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Recurrent spiking layer over TS parallel time steps.

    stim_base/s_prev: (TS, B, H); w: (H, H); u0/h0: (B, H); beta/vth (H,).
    ``rec = s_prev @ w`` for all time steps at once (one read of ``w``),
    then the LIF chain ``u = stim[t] + (beta*u)*(1-h)``, ``h = u >= vth``.
    Returns (spikes (TS, B, H) float32, u_final (B, H)).
    """
    stim = stim_base + torch.matmul(s_prev, w)
    u, h = u0, h0
    spikes = []
    for ts in range(stim.shape[0]):
        u = stim[ts] + beta * u * (1.0 - h)
        h = (u >= vth).to(stim.dtype)
        spikes.append(h)
    return torch.stack(spikes), u


def unpack_int4_ref(packed: torch.Tensor) -> torch.Tensor:
    """(K//2, N) int8 -> (K, N) int8 in [-8, 7] (low nibble = even row)."""
    return unpack_int4(packed)


def int4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) float32 @ unpacked int4 (K, N), then ``* scale`` (N,).
    Returns (M, N) float32."""
    w = unpack_int4_ref(packed).to(torch.float32)
    return (x.to(torch.float32) @ w) * scale.to(torch.float32)


def merged_spike_fc_ref(spikes_ts: torch.Tensor, packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Merged-spike FC (paper §II-D2) with int4 weights: spikes (TS, B, H)
    summed over TS (values in {0..TS}), then one int4 matmul."""
    return int4_matmul_ref(spikes_ts.sum(dim=0), packed, scale)


def sparse_fc_ref(spikes_ts: torch.Tensor, indices: torch.Tensor,
                  values: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Zero-skip FC over padded-CSC columns: the merged spikes gathered
    at ``indices`` (nnz_max, N), times ``values``, summed over the nnz
    axis, then scaled (``core.layouts.csc.sparse_matmul``).

    spikes_ts: (TS, B, H) (or pre-merged (B, H)); scale: (N,) or (1, N).
    """
    from repro_torch.core.layouts.csc import SparseColumns, sparse_matmul

    merged = spikes_ts.sum(dim=0) if spikes_ts.dim() == 3 else spikes_ts
    sc = SparseColumns(indices=indices, values=values,
                       scale=scale.reshape(1, -1))
    return sparse_matmul(merged, sc)
