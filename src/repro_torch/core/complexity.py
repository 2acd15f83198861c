"""Measured sparsity and the zero-skip complexity it drives: the counters
``StreamLoop`` accumulates, the density profile they convert to (paper
Fig. 18), and the accumulates/MMAC/s accounting over it (paper Fig. 13;
the reference's ``core/complexity.py``, whose conventions it keeps: the
8-bit input layer runs bit-serially once a frame, every other layer costs
one accumulate per weight per time step, zero-skipping scales each term by
its measured density, merged spikes read the FC once over the union of
the two spike trains, 100 frames a second).

The reference's model-size, weight-access, cycle and power models are not
ported yet; they are pure Python too.
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
