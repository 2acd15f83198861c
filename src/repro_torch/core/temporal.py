"""Inherent temporal training (paper §II-A, ref [22]).

Start training with a high SNN time-step count and progressively reduce it,
using each higher-ts model as the pre-trained init for the next.  The
carried state's shape changes with TS, the parameters' do not, so the
annealing is a schedule over ``num_ts`` handed to the trainer.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TemporalSchedule:
    """E.g. stages=((4, 2000), (2, 2000), (1, 2000)): 2000 steps at ts=4,
    then fine-tune at ts=2, then ts=1."""

    stages: tuple[tuple[int, int], ...] = ((4, 1000), (2, 1000), (1, 1000))

    def ts_at(self, step: int) -> int:
        acc = 0
        for ts, n in self.stages:
            acc += n
            if step < acc:
                return ts
        return self.stages[-1][0]

    @property
    def total_steps(self) -> int:
        return sum(n for _, n in self.stages)

    @property
    def boundaries(self) -> list[int]:
        out, acc = [], 0
        for _, n in self.stages[:-1]:
            acc += n
            out.append(acc)
        return out
