"""Plain PyTorch versions of the hand-written CUDA kernels.

Each function computes what its kernel computes, in the kernel's order of
the float operations that are not exact, so that:

  * on a CPU tensor, ``kernels/ops.py`` runs these instead of the kernel;
  * on the card, ``chip_smoke.py`` holds each kernel against them;
  * on the CPU, the tests hold them against the reference's Pallas kernels
    in interpret mode.

The int4 products (``int4_matmul_ref``, ``merged_spike_fc_ref``,
``sparse_fc_ref``, ``nm_fc_ref``) accumulate integer-valued products and
apply the per-channel scale once at the end, as the Pallas kernels do:
with 8-bit inputs or spikes in {0..TS} every partial sum is an integer
below 2**24, so any summation order gives the same float and the results
agree bit for bit.  ``rsnn_cell_ref`` sums float32 dequantized weights,
whose result depends on the order; it agrees within a stated tolerance, as
do ``delta_step_ref``'s recomputed rows, ``spike_broadcast_ref`` and
``spike_cell_ref``.  ``compact_spikes`` (the event lists of K9/K10) and
``delta_step_ref``'s mask, held input and cached rows are exact.
``megastep_ref`` (K6/K7) composes these: its potentials agree within the
stated tolerance, its counters exactly, and its int4 logits bit for bit
given equal merged spikes; its float logits (``dense_float``, float32
sums) within the stated tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.core import spike_ops
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
    return _lif_chain(stim_base + torch.matmul(s_prev, w), u0, h0, beta, vth)


def _lif_chain(stim, u0, h0, beta, vth):
    """``u = stim[t] + (beta*u)*(1-h)``, ``h = u >= vth`` for t = 0..TS-1.
    Returns (spikes (TS, B, H), u_final (B, H))."""
    u, h = u0, h0
    spikes = []
    for ts in range(stim.shape[0]):
        u = stim[ts] + beta * u * (1.0 - h)
        h = (u >= vth).to(stim.dtype)
        spikes.append(h)
    return torch.stack(spikes), u


def delta_step_ref(x: torch.Tensor, x_prev: torch.Tensor,
                   pre_prev: torch.Tensor, w: torch.Tensor,
                   threshold: float
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Delta-temporal input gating (EdgeDRNN).

    ``mask = |x - x_prev| > threshold`` (strict), ``x_hat = where(mask, x,
    x_prev)``; a row with a propagated element gets ``x_hat @ w``, a row
    with none keeps ``pre_prev``'s bits.  At ``threshold=0`` ``x_hat``
    equals ``x`` elementwise.

    x/x_prev: (B, D); pre_prev: (B, H); w: (D, H).  Returns (x_hat (B, D),
    pre (B, H), mask (B, D) float {0, 1}).
    """
    mask = (x - x_prev).abs() > threshold
    x_hat = torch.where(mask, x, x_prev)
    changed = mask.any(dim=1, keepdim=True)
    pre = torch.where(changed, torch.matmul(x_hat, w), pre_prev)
    return x_hat, pre, mask.to(torch.float32)


def compact_spikes(x: torch.Tensor, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row of ``x`` (R, K) as an ascending-index event list.

    Returns ``(idx, vals)``, each (R, capacity): ``idx[r, j]`` is the
    column of row r's (j+1)-th nonzero (clamped to K-1 past the end) and
    ``vals[r, j]`` its value, 0 on padding.  A row with more than
    ``capacity`` nonzeros drops its highest-index ones.  The reference's
    cumsum/compare cascade, expression for expression.
    """
    r, k = x.shape
    cnt = torch.cumsum((x != 0).to(torch.int32), dim=1)  # (R, K) inclusive
    slot = torch.arange(capacity, dtype=torch.int32,
                        device=x.device).reshape(1, capacity, 1)
    idx = (cnt[:, None, :] <= slot).sum(dim=2)  # (R, capacity)
    idx = torch.clamp(idx, max=k - 1)
    valid = torch.arange(capacity, device=x.device).reshape(1, capacity) \
        < cnt[:, -1:]
    vals = torch.take_along_dim(x, idx, dim=1)
    vals = torch.where(valid, vals, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))
    return idx, vals


def gather_matmul(x: torch.Tensor, w: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """``x (R, K) @ w (K, N)`` over each row's event list: only the rows of
    ``w`` the events name are gathered, and the accumulate runs over the
    event axis.  Returns (R, N) float32."""
    idx, vals = compact_spikes(x, capacity)
    r = x.shape[0]
    g = w[idx.reshape(-1)].reshape(r, capacity, w.shape[1])
    return torch.einsum("rc,rcn->rn", vals, g)


def spike_broadcast_ref(x: torch.Tensor, w: torch.Tensor,
                        capacity: int | None = None) -> torch.Tensor:
    """Event-driven ``x @ w`` as a dense product over the kept events.

    ``x``: (R, K) rows, or (TS, B, K) spike trains merged over TS first
    (values in {0..TS}); ``w``: (K, N).  Each row keeps its first
    ``capacity`` nonzero entries in ascending index order (``None``: all of
    them, the plain ``x @ w``).  Returns (R|B, N) float32.
    """
    if x.dim() == 3:
        x = x.sum(dim=0)
    x = x.to(torch.float32)
    if capacity is not None:
        cnt = torch.cumsum((x != 0).to(torch.int32), dim=1)
        x = torch.where(cnt <= capacity, x, torch.zeros((), device=x.device))
    return torch.matmul(x, w.to(torch.float32))


def spike_cell_ref(stim_base: torch.Tensor, s_prev: torch.Tensor,
                   w: torch.Tensor, u0: torch.Tensor, h0: torch.Tensor,
                   beta: torch.Tensor, vth: torch.Tensor,
                   capacity: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``rsnn_cell_ref`` with the recurrent product over spike events: TS
    folds into the event-row axis (``s_prev.reshape(TS*B, H)``), each row
    keeps its first ``capacity`` events.  At ``capacity=None`` it is
    ``rsnn_cell_ref``."""
    ts, b, h = s_prev.shape
    rec = spike_broadcast_ref(s_prev.reshape(ts * b, h), w, capacity)
    return _lif_chain(stim_base + rec.reshape(ts, b, -1), u0, h0, beta, vth)


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


def nm_fc_ref(spikes_ts: torch.Tensor, packed: torch.Tensor,
              scale: torch.Tensor, *, n: int, m: int) -> torch.Tensor:
    """Zero-skip FC over the group-packed N:M layout: the merged spikes
    gathered at each entry's row ``(e // n) * m + offset``, times its int4
    value, summed over the entry axis, then scaled
    (``core.layouts.nm.nm_matmul``).

    spikes_ts: (TS, B, H) (or pre-merged (B, H)); packed: (groups * n, N)
    int8 value | offset << 4; scale: (N,) or (1, N).
    """
    from repro_torch.core.layouts.nm import NMGroupPacked, nm_matmul

    merged = spikes_ts.sum(dim=0) if spikes_ts.dim() == 3 else spikes_ts
    t = NMGroupPacked(packed=packed, scale=scale.reshape(1, -1), count=None,
                      n=n, m=m, rows=packed.shape[0] // n * m)
    return nm_matmul(merged, t)


# the mega-step's FC modes at each precision of its layer weights
MEGASTEP_FC_MODES = {"int4": ("dense_int4", "csc", "nm"),
                     "float": ("dense_float",)}


def check_megastep_modes(precision: str, fc_mode: str) -> None:
    """Raise unless ``fc_mode`` is an FC mode of the mega-step at
    ``precision``: the float layer weights come with the float FC
    (``dense_float``), the int4 ones with an int4 layout's FC."""
    if precision not in MEGASTEP_FC_MODES:
        raise ValueError(f"megastep: unknown precision {precision!r}; it "
                         f"serves {sorted(MEGASTEP_FC_MODES)}")
    if fc_mode not in MEGASTEP_FC_MODES[precision]:
        raise ValueError(f"megastep: fc_mode {fc_mode!r} at precision "
                         f"{precision!r}; that precision serves "
                         f"{MEGASTEP_FC_MODES[precision]}")


def megastep_ref(x, s0, u0, h0, s1, u1, h1, beta0, vth0, beta1, vth1,
                 wargs: tuple, fcargs: tuple, *, fc_mode: str,
                 input_bits: int, precision: str = "int4", nm_n: int = 0,
                 nm_m: int = 0, spike: bool = False):
    """The whole frame step over an F-frame chunk (K6; K7 at
    ``spike=True``), composed from the plain versions above in the
    reference oracle's order.

    ``x`` (F, B, D) quantized frames; ``s0``/``s1`` (TS, B, H) the previous
    frame's spike trains, 0/1 only (K6/K7 keep them as bits and read any
    nonzero entry as 1: the function is defined on 0/1 trains, which the
    served state always is); ``u*``/``h*`` (B, H) the LIF carries (``h*`` the
    last spike, ``lif*.spike``); ``beta*``/``vth*`` (H,); ``wargs`` the
    layer weights ``l0_wx, l0_wh, l1_wx, l1_wh``: at ``precision="int4"``
    their packed ``(q, scale)`` pairs, at ``"float"`` the four dense
    float32 (K, H) matrices.  ``fcargs`` per ``fc_mode``: ``(w_fc,)``
    (H, N) float32 for ``"dense_float"`` (float only), ``(packed, scale)``
    for ``"dense_int4"``, ``(indices, values, scale)`` for ``"csc"`` or the
    group-packed ``(packed, scale)`` for ``"nm"`` with ``nm_n`` of every
    ``nm_m`` rows (int4 only).
    ``spike=True`` runs the three spike-consuming products (L0 recurrent,
    L1 feed-forward, L1 recurrent) and the dense FC through
    ``gather_matmul`` at lossless capacity; the ``dense_int4`` FC gathers
    the int4 values and scales once, as K3 does, so its integer sums equal
    the dense readout's bit for bit; ``dense_float`` gathers the float
    rows of ``w_fc``, as the reference's spike mode does.  The ``csc`` and
    ``nm`` readouts skip on the weight side and keep their own gather in
    both modes, as the reference does.

    Returns ``(s0, u0, s1, u1, logits (F, B, N), spikes_l0 (F, TS, B),
    spikes_l1 (F, TS, B), union_l1 (F, B), input_one_bits (F, B))``.
    """
    check_megastep_modes(precision, fc_mode)
    if precision == "float":
        w0x, w0h, w1x, w1h = wargs
    else:
        w0x, w0h, w1x, w1h = (unpack_int4_ref(q).to(torch.float32) * sc
                              for q, sc in zip(wargs[0::2], wargs[1::2]))
    ts, b, h = s0.shape

    def cell(stim, s_prev, w, u, hh, beta, vth):
        if not spike:
            return rsnn_cell_ref(stim, s_prev, w, u, hh, beta, vth)
        rec = gather_matmul(s_prev.reshape(ts * b, h), w, h)
        return _lif_chain(stim + rec.reshape(ts, b, -1), u, hh, beta, vth)

    def readout(s):
        if fc_mode == "csc":
            return sparse_fc_ref(s, *fcargs)
        if fc_mode == "nm":
            return nm_fc_ref(s, *fcargs, n=nm_n, m=nm_m)
        if fc_mode == "dense_float":
            (w_fc,) = fcargs
            merged = s.sum(dim=0)
            return gather_matmul(merged, w_fc, h) if spike else merged @ w_fc
        packed, scale = fcargs
        if not spike:
            return merged_spike_fc_ref(s, packed, scale.reshape(-1))
        w = unpack_int4_ref(packed).to(torch.float32)
        return gather_matmul(s.sum(dim=0), w, h) \
            * scale.reshape(-1).to(torch.float32)

    logits, sp0, sp1, union, bits = [], [], [], [], []
    for f in range(x.shape[0]):
        xf = x[f].to(torch.float32)
        stim0 = (xf @ w0x).unsqueeze(0).expand(ts, b, h)
        s0, u0 = cell(stim0, s0, w0h, u0, h0, beta0, vth0)
        h0 = s0[-1]
        s0_rows = s0.reshape(ts * b, h)
        ff1 = gather_matmul(s0_rows, w1x, h) if spike else s0_rows @ w1x
        s1, u1 = cell(ff1.reshape(ts, b, h), s1, w1h, u1, h1, beta1, vth1)
        h1 = s1[-1]
        logits.append(readout(s1))
        sp0.append(s0.sum(dim=2))
        sp1.append(s1.sum(dim=2))
        union.append(s1.amax(dim=0).sum(dim=1))
        bits.append(spike_ops.bitplanes(xf, input_bits).sum(dim=(1, 2))
                    .to(torch.float32))
    return (s0, u0, s1, u1, torch.stack(logits), torch.stack(sp0),
            torch.stack(sp1), torch.stack(union), torch.stack(bits))
