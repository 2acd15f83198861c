"""The traffic generator: every mix is a data file it reads.

A mix (``bench/traffic/<name>.json``) names its arrivals' ``mode``; the
rest of its keys are the family's that serves it, which checks them
(``families/<family>.py``).  The RSNN family's mixes give the loop's shape
(``slots``, ``chunk_frames``, ``pipeline_depth``, ``ring_frames``), the
utterance lengths (``min_frames``, ``max_frames``), the size of the
feature pool (``pool``), how many served streams the check compares
(``check``), and its arrivals: ``"mode": "backlog"`` keeps at least
``backlog`` streams queued (a closed loop: offline transcription of a
standing backlog); ``"mode": "open"`` submits Poisson arrivals at
``rate`` streams/s (an open loop: independent users), after ``warmup_s``
seconds of the same arrivals.

Every seed gets the same multiset of lengths and of inter-arrival gaps,
in another order: two seeds differ in content and order, not in the
amount of work.  Percentiles are nearest-rank.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from bench.reference import data

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    """The mix ``bench/traffic/<name>.json``, which names its ``mode``."""
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if not isinstance(mix.get("mode"), str) or not mix["mode"]:
        raise ValueError(f"traffic {name!r}: no mode")
    return mix


def nearest_rank(samples, p: float) -> float:
    """The smallest sample such that at least ``p`` percent of the samples
    are <= it (rank ``ceil(p / 100 * n)``, 1-indexed): always an observed
    sample."""
    if not 0 <= p <= 100:
        raise ValueError(f"percentile must be in [0, 100], got {p}")
    xs = sorted(float(x) for x in samples)
    if not xs:
        raise ValueError("no samples")
    return xs[max(1, math.ceil(p / 100.0 * len(xs))) - 1]


class Pool:
    """The run's utterances: ``count`` feature sequences whose lengths are
    the mix's evenly spaced multiset in the seed's order."""

    def __init__(self, mix: dict, cfg: dict, seed: int, device):
        self.lengths = data.lengths(mix["pool"], mix["min_frames"],
                                    mix["max_frames"], seed)
        self.frames, self.offsets = data.feature_pool(
            self.lengths, cfg["input_dim"], seed, device)

    def __len__(self) -> int:
        return len(self.lengths)

    def utterance(self, k: int) -> np.ndarray:
        return self.frames[self.offsets[k]:self.offsets[k + 1]]


def submission_order(count: int, seed: int):
    """Pool indices in the order they are submitted: a fresh seeded
    permutation of the pool each time round."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 3])
    while True:
        yield from rng.permutation(count).tolist()


def arrival_offsets(rate: float, seconds: float, seed: int, stream: int
                    ) -> np.ndarray:
    """Poisson arrivals at ``rate`` a second over ``seconds``: the offsets
    (s) of ``round(rate * seconds)`` arrivals whose gaps are the evenly
    spaced quantiles of the exponential distribution, scaled to fill the
    span exactly, in the seed's order (``stream`` keeps the warm-up's
    order apart from the window's)."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng([int(seed) % 2 ** 63, 4 + stream])
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])
