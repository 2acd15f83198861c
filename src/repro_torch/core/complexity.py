"""Measured sparsity and the complexity it drives: the counters
``StreamLoop`` accumulates, the density profile they convert to (paper
Fig. 18), the accumulates/MMAC/s accounting over it (paper Fig. 13), and
the paper's accelerator model: model size (Fig. 12), weight accesses
(§II-C), cycles a frame on the dual 128-PE design (Fig. 17), the real-time
clock, and power, energy and TOPS/W (Figs. 19-20, Table III).

The reference's ``core/complexity.py`` in plain Python floats, operation
for operation, so every function returns the reference's float for the
same arguments.  Its conventions: the 8-bit input layer runs bit-serially
once a frame, every other layer costs one accumulate per weight per time
step, zero-skipping scales each term by its measured density, merged
spikes read the FC once over the union of the two spike trains, 100 frames
a second.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.rsnn import RSNNConfig

FRAMES_PER_SECOND = 100  # 25-ms window, 10-ms shift


@dataclasses.dataclass(frozen=True)
class SparsityProfile:
    """Measured densities (= 1 - sparsity) driving zero-skip accounting.

    Defaults are the paper's Fig. 18 operating point.
    """

    input_bit_density: float = 0.43  # ~57% input-bit sparsity
    l0_density: tuple[float, float] = (0.38, 0.38)  # per ts
    l1_density: tuple[float, float] = (0.38, 0.38)
    fc_density: tuple[float, float] = (0.38, 0.38)  # density of L1 output spikes
    fc_union_density: float = 0.46  # OR of the two ts spike trains (merged)
    # delta-temporal gating: fraction of input elements past the gate
    # (1.0 = no temporal skipping, as on every ported backend)
    delta_input_density: float = 1.0


@dataclasses.dataclass
class SparsityCounters:
    """Running spike/bit counters measured by the streaming engine: one
    ``update`` per processed step, reduced over the active slots."""

    num_ts: int
    hidden_dim: int
    input_dim: int
    input_bits: int
    frames: float = 0.0  # active stream-frames seen
    spikes_l0: list = dataclasses.field(init=False)  # per-ts running totals
    spikes_l1: list = dataclasses.field(init=False)
    union_l1: float = 0.0
    input_one_bits: float = 0.0
    delta_propagated: float = 0.0  # input elements past the delta gate
    delta_skipped: float = 0.0  # input elements held (temporal skip)

    def __post_init__(self):
        self.spikes_l0 = [0.0] * self.num_ts
        self.spikes_l1 = [0.0] * self.num_ts

    def update(self, aux: dict, active_frames: float) -> None:
        """aux: counters of one engine step, already reduced over the
        active slots (floats or 0-d arrays)."""
        self.frames += active_frames
        for ts in range(self.num_ts):
            self.spikes_l0[ts] += float(aux["spikes_l0"][ts])
            self.spikes_l1[ts] += float(aux["spikes_l1"][ts])
        self.union_l1 += float(aux["union_l1"])
        self.input_one_bits += float(aux["input_one_bits"])
        self.delta_propagated += float(aux.get("delta_propagated", 0.0))
        self.delta_skipped += float(aux.get("delta_skipped", 0.0))

    def profile(self) -> SparsityProfile:
        denom = max(self.frames, 1.0) * self.hidden_dim
        l0 = tuple(s / denom for s in self.spikes_l0)
        l1 = tuple(s / denom for s in self.spikes_l1)
        bit_denom = max(self.frames, 1.0) * self.input_dim * self.input_bits
        delta_total = self.delta_propagated + self.delta_skipped
        delta_density = (self.delta_propagated / delta_total
                         if delta_total > 0 else 1.0)
        return SparsityProfile(
            input_bit_density=self.input_one_bits / bit_denom,
            l0_density=l0, l1_density=l1, fc_density=l1,
            fc_union_density=self.union_l1 / denom,
            delta_input_density=delta_density)

    def mmac_per_second(self, cfg: RSNNConfig, merged_spike: bool = True,
                        fc_prune_frac: float = 0.0) -> float:
        """Measured-sparsity MMAC/s (the paper's 13.86 MMAC/s style
        figure)."""
        return mmac_per_second(cfg, self.num_ts, sparsity=self.profile(),
                               merged_spike=merged_spike,
                               fc_prune_frac=fc_prune_frac)


def accumulates_per_frame(cfg: RSNNConfig, num_ts: int,
                          sparsity: SparsityProfile | None = None,
                          merged_spike: bool = False,
                          fc_prune_frac: float = 0.0) -> float:
    """Effective accumulate count per 10-ms frame.

    ``sparsity=None`` means no zero-skipping (dense accounting).
    """
    s = sparsity or SparsityProfile(1.0, (1.0,) * 2, (1.0,) * 2, (1.0,) * 2,
                                    1.0)
    h = cfg.hidden_dim
    # the input layer's bit-serial pass only visits delta-propagated
    # elements (1.0 when not measured)
    inp = (cfg.input_bits * cfg.input_dim * h
           * s.input_bit_density * s.delta_input_density)  # once/frame
    rec = 0.0
    for ts in range(num_ts):
        rec += h * h * s.l0_density[ts]  # L0-recurrent, input spikes = h0[ts]
        rec += h * h * s.l0_density[ts]  # L1-feedforward consumes L0 spikes
        rec += h * h * s.l1_density[ts]  # L1-recurrent
    fc_w = h * cfg.fc_dim * (1.0 - fc_prune_frac)
    if merged_spike and num_ts == 2:
        fc = fc_w * s.fc_union_density
    else:
        fc = sum(fc_w * s.fc_density[ts] for ts in range(num_ts))
    return inp + rec + fc


def mmac_per_second(cfg: RSNNConfig, num_ts: int, **kw) -> float:
    return accumulates_per_frame(cfg, num_ts, **kw) * FRAMES_PER_SECOND / 1e6


def spike_broadcast_report(cfg: RSNNConfig, num_ts: int,
                           sparsity: SparsityProfile | None = None,
                           merged_spike: bool = True,
                           fc_prune_frac: float = 0.0) -> dict:
    """Gathered-vs-dense accumulates of the spike-consuming matmuls.

    The ``spike`` backend accumulates only the W rows named by spike
    events, so its work per frame is the density-scaled slice of
    ``accumulates_per_frame`` that consumes spikes: the L0/L1-recurrent
    and L1-feedforward matmuls plus the (merged-spike) FC readout; the
    analog input layer is excluded.  The dense figures are the same terms
    at density 1.0.  ``sparsity=None`` uses the paper's Fig. 18 defaults.
    """
    s = sparsity or SparsityProfile()
    h = cfg.hidden_dim
    rec = sum(h * h * (2.0 * s.l0_density[ts] + s.l1_density[ts])
              for ts in range(num_ts))
    rec_dense = 3.0 * h * h * num_ts
    fc_w = h * cfg.fc_dim * (1.0 - fc_prune_frac)
    if merged_spike and num_ts == 2:
        fc, fc_dense = fc_w * s.fc_union_density, fc_w
    else:
        fc = sum(fc_w * s.fc_density[ts] for ts in range(num_ts))
        fc_dense = fc_w * num_ts
    gathered, dense = rec + fc, rec_dense + fc_dense
    return {
        "recurrent_gathered": rec, "recurrent_dense": rec_dense,
        "fc_gathered": fc, "fc_dense": fc_dense,
        "gathered": gathered, "dense": dense,
        "skip_fraction": 1.0 - gathered / dense,
    }


def model_size_bytes(cfg: RSNNConfig, weight_bits: int = 32,
                     fc_prune_frac: float = 0.0) -> float:
    """Weight storage in bytes.  fc_prune_frac = unstructured-pruned
    fraction of FC weights (paper: 40%)."""
    shapes = cfg.layer_shapes
    fc = shapes["fc_w"][0] * shapes["fc_w"][1] * (1.0 - fc_prune_frac)
    rest = sum(a * b for n, (a, b) in shapes.items() if n != "fc_w")
    return (rest + fc) * weight_bits / 8.0


def num_params(cfg: RSNNConfig, fc_prune_frac: float = 0.0) -> int:
    return int(model_size_bytes(cfg, 8, fc_prune_frac))


def weight_accesses_per_frame(cfg: RSNNConfig, num_ts: int,
                              parallel_time_steps: bool) -> int:
    """Weight-buffer reads per frame (paper §II-C dataflow comparison)."""
    h = cfg.hidden_dim
    inp = cfg.input_bits * cfg.input_dim * h  # re-read per bit plane
    body = 3 * h * h + h * cfg.fc_dim
    ts_factor = 1 if parallel_time_steps else num_ts
    return inp + ts_factor * body


def cycles_per_frame(cfg: RSNNConfig, num_ts: int,
                     sparsity: SparsityProfile | None = None,
                     merged_spike: bool = False) -> float:
    """Cycle count for one frame on the 2 x 128-PE accelerator.

    Conventions (the reference's, validated against Fig. 17's 2464/1312
    -> 1224/574 -> 895):
      * input: 40 features x 8 bit planes, split over the 2 PE sets
        -> 160 cycles dense; type-A skips zero bits.
      * recurrent layers (H=128): one broadcast cycle per input spike.
        2 ts: the sets run the two ts in parallel (type-D, NO skipping to
        keep single-port SRAM). 1 ts: work splits across sets (type-B,
        skipping active).
      * FC (1920 outputs = 15 blocks of 128 PEs): 2 ts unmerged -> sets
        run ts in parallel, type-B skip per ts; merged -> one pass over
        the spike union, blocks split across BOTH sets.
    """
    if not (cfg.hidden_dim % 128 == 0 or cfg.hidden_dim == 128):
        raise ValueError(f"the cycle model maps hidden {cfg.hidden_dim} "
                         f"onto 128-PE sets; it needs a multiple of 128")
    s = sparsity or SparsityProfile(1.0, (1.0,) * 2, (1.0,) * 2, (1.0,) * 2,
                                    1.0)
    skip = sparsity is not None

    inp = cfg.input_dim * cfg.input_bits / 2 * (
        s.input_bit_density if skip else 1.0)

    h = cfg.hidden_dim
    if num_ts == 2:
        # type-D: parallel time steps, no zero-skip on recurrent layers
        rec = 3 * h
    else:
        dens = ([s.l0_density[0], s.l0_density[0], s.l1_density[0]] if skip
                else [1] * 3)
        rec = sum(h / 2 * d for d in dens)

    blocks = cfg.fc_dim / 128
    if num_ts == 2:
        if merged_spike:
            fc = blocks / 2 * h * (s.fc_union_density if skip else 1.0)
        else:
            fc = blocks * h * (max(s.fc_density) if skip else 1.0)
    else:
        fc = blocks / 2 * h * (s.fc_density[0] if skip else 1.0)
    return inp + rec + fc


def realtime_frequency_hz(cycles: float) -> float:
    """Minimum clock for real-time operation (one frame per 10 ms)."""
    return cycles / 0.010


# Power / energy model (paper Fig. 19/20, Table III).  Two published
# operating points (TSMC 28 nm, 0.8 V): 71.2 uW at 100 kHz and 35.5 mW at
# 500 MHz give a leakage + per-cycle-switching split,
#   P(f) = P_LEAK + E_CYCLE * f
E_CYCLE = (35.5e-3 - 71.2e-6) / (500e6 - 100e3)  # ~70.9 pJ / cycle
P_LEAK = 71.2e-6 - E_CYCLE * 100e3  # ~64.1 uW


def power_w(freq_hz: float) -> float:
    """Core power at a given clock (interpolates the paper's two points)."""
    return P_LEAK + E_CYCLE * freq_hz


def energy_per_frame_j(cycles: float, freq_hz: float) -> float:
    """Active + leakage energy for one 10-ms frame processed in
    ``cycles``: Table III's 63.5 nJ a frame at 500 MHz (895 cycles) and
    ~637 nJ at the 100 kHz always-on point (= 71.2 uW x 8.95 ms)."""
    t_frame = cycles / freq_hz
    return cycles * E_CYCLE + P_LEAK * t_frame


def tops_per_watt(cfg: RSNNConfig, num_ts: int, freq_hz: float = 500e6,
                  cycles: float | None = None,
                  sparsity: SparsityProfile | None = None,
                  merged_spike: bool = True) -> float:
    """Energy efficiency in dense-equivalent TOPS/W (2 ops an
    accumulate).  The paper's 28.41 TOPS/W lies between the skipped-ops
    (lower) and dense-equivalent (upper) conventions."""
    cyc = cycles if cycles is not None else cycles_per_frame(
        cfg, num_ts, sparsity=sparsity, merged_spike=merged_spike)
    frames_per_s = freq_hz / cyc
    dense_ops = 2.0 * accumulates_per_frame(cfg, num_ts) * frames_per_s
    return dense_ops / power_w(freq_hz) / 1e12
