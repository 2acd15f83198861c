"""Measured sparsity: the counters ``StreamLoop`` accumulates and the
density profile they convert to (paper Fig. 18).

The analytical MMAC/s, cycle and power models of the reference are not
ported yet; they take a ``SparsityProfile`` and are pure Python.
"""

from __future__ import annotations

import dataclasses


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
