"""Device dispatch for the hand-written kernels.

A CPU tensor runs the kernel's plain PyTorch version (``ref.py``); a CUDA
tensor launches the CUDA kernel, and a build or launch failure raises —
nothing falls back.  Any other device raises.  The first argument's device
decides; the CUDA wrappers check that every operand lies on it.

Each wrapper adds one to its launch counter where it launches its kernel
(``COUNTERS``).  A captured CUDA graph runs no Python when it replays, so
the slot loop credits a graph's launches to these counters at every replay
(``add_launch_counts``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import delta_step as _delta
from repro_torch.kernels import int4_matmul as _i4
from repro_torch.kernels import megastep as _mega
from repro_torch.kernels import merged_spike_fc as _mfc
from repro_torch.kernels import nm_fc as _nfc
from repro_torch.kernels import ref
from repro_torch.kernels import rsnn_cell as _cell
from repro_torch.kernels import sparse_fc as _sfc
from repro_torch.kernels import spike_broadcast as _sb


# kernel name -> (wrapper module, the name of its launch counter there)
COUNTERS = {"rsnn_cell": (_cell, "launches"),
            "int4_matmul": (_i4, "launches"),
            "merged_spike_fc": (_mfc, "launches"),
            "sparse_fc": (_sfc, "launches"),
            "nm_fc": (_nfc, "launches"),
            "delta_step": (_delta, "launches"),
            "spike_broadcast": (_sb, "launches"),
            "spike_cell": (_sb, "cell_launches"),
            "megastep": (_mega, "launches"),
            "megastep_spike": (_mega, "spike_launches")}


def launch_counts() -> dict[str, int]:
    """Every kernel's launch count in this process, by kernel name."""
    return {n: getattr(m, a) for n, (m, a) in COUNTERS.items()}


def set_launch_counts(counts: dict[str, int]) -> None:
    for n, c in counts.items():
        m, a = COUNTERS[n]
        setattr(m, a, c)


def add_launch_counts(counts: dict[str, int]) -> None:
    """Credit ``counts`` launches to the kernels it names."""
    for n, c in counts.items():
        m, a = COUNTERS[n]
        setattr(m, a, getattr(m, a) + c)


def _plain(op: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises otherwise."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{op}: no kernel or plain version for a tensor on "
                     f"{t.device}")


def rsnn_cell(stim_base, s_prev, w, u0, h0, beta, vth):
    if _plain("rsnn_cell", s_prev):
        return ref.rsnn_cell_ref(stim_base, s_prev, w, u0, h0, beta, vth)
    return _cell.rsnn_cell(stim_base, s_prev, w, u0, h0, beta, vth)


def int4_matmul(x, packed, scale):
    if _plain("int4_matmul", x):
        return ref.int4_matmul_ref(x, packed, scale)
    return _i4.int4_matmul(x, packed, scale)


def merged_spike_fc(spikes_ts, packed, scale):
    if _plain("merged_spike_fc", spikes_ts):
        return ref.merged_spike_fc_ref(spikes_ts, packed, scale)
    return _mfc.merged_spike_fc(spikes_ts, packed, scale)


def sparse_fc(spikes_ts, indices, values, scale):
    if _plain("sparse_fc", spikes_ts):
        return ref.sparse_fc_ref(spikes_ts, indices, values, scale)
    return _sfc.sparse_fc(spikes_ts, indices, values, scale)


def nm_fc(spikes_ts, packed, scale, *, n, m):
    if _plain("nm_fc", spikes_ts):
        return ref.nm_fc_ref(spikes_ts, packed, scale, n=n, m=m)
    return _nfc.nm_fc(spikes_ts, packed, scale, n=n, m=m)


def delta_step(x, x_prev, pre_prev, w, threshold):
    if _plain("delta_step", x):
        return ref.delta_step_ref(x, x_prev, pre_prev, w, threshold)
    return _delta.delta_step(x, x_prev, pre_prev, w, threshold)


def spike_broadcast(x, w, *, capacity=None):
    if _plain("spike_broadcast", x):
        _sb.event_capacity(capacity, x.shape[-1])
        return ref.spike_broadcast_ref(x, w, capacity)
    return _sb.spike_broadcast(x, w, capacity=capacity)


def spike_cell(stim_base, s_prev, w, u0, h0, beta, vth, *, capacity=None):
    if _plain("spike_cell", s_prev):
        _sb.event_capacity(capacity, s_prev.shape[-1])
        return ref.spike_cell_ref(stim_base, s_prev, w, u0, h0, beta, vth,
                                  capacity)
    return _sb.spike_cell(stim_base, s_prev, w, u0, h0, beta, vth,
                          capacity=capacity)


def megastep(x, s0, u0, h0, s1, u1, h1, beta0, vth0, beta1, vth1, wargs,
             fcargs, *, fc_mode, input_bits, precision="int4", nm_n=0,
             nm_m=0, spike=False):
    kw = dict(fc_mode=fc_mode, input_bits=input_bits, precision=precision,
              nm_n=nm_n, nm_m=nm_m, spike=spike)
    args = (x, s0, u0, h0, s1, u1, h1, beta0, vth0, beta1, vth1, wargs,
            fcargs)
    if _plain("megastep", x):
        return ref.megastep_ref(*args, **kw)
    return _mega.megastep(*args, **kw)
