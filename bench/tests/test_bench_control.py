"""The check that decides ``correct`` has to fail: its control (the
reference one precision below the configuration's, in the program's place)
and a run whose timed path is broken underneath, on the CPU at a size a
test run holds.  The same faults run through the whole harness, the
card's look aside."""

import json

import pytest
import torch

from bench_tiny import CELLS, ROOT, tiny_files, tiny_run

from bench import control
from repro_torch.serving import stream

LIMITS = {c: json.loads((ROOT / "bench" / "cells" / f"{c}.json").read_text())
          ["limits"]["diverged_decided_pct"] for c in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    _, cfg, mix, _ = tiny_files(cell, hidden=64, fc=128)
    mix = dict(mix, min_frames=60, max_frames=120)
    got = control.control_reading(cfg, mix, 2 ** 31 + 3, 16,
                                  torch.device("cpu"))
    assert got["diverged_decided_pct"] > 3 * LIMITS[cell]


def _unchanged_state(orig):
    def step(self, state, x):
        _, logits, aux = orig(self, state, x)
        return state, logits, aux
    return step


def _half_batch(orig):
    """The second half of the slots left out: their state does not move
    and their logits stay zero."""
    def step(self, state, x):
        new, logits, aux = orig(self, state, x)
        half = x.shape[1] // 2
        for a, b in zip(stream._leaves(new), stream._leaves(state)):
            dim = 1 if a.dim() == 3 else 0
            a.narrow(dim, half, a.shape[dim] - half).copy_(
                b.narrow(dim, half, b.shape[dim] - half))
        logits = logits.clone()
        logits[:, half:] = 0.0
        return new, logits, aux
    return step


def _altered_answer(orig):
    """Every answer altered where it is produced: one logit of each frame
    moved by 0.05."""
    def step(self, state, x):
        new, logits, aux = orig(self, state, x)
        logits = logits.clone()
        logits[..., 0] += 0.05
        return new, logits, aux
    return step


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}
# the faults each cell can have: an open loop below capacity refills the
# lowest free slots first and never reaches the second half of the batch
CELL_FAULTS = [(c, f) for c in CELLS for f in sorted(FAULTS)
               if not (f == "half_batch" and c.endswith("-open"))]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(stream.CompiledRSNN, "_chunk_step",
                        FAULTS[fault](stream.CompiledRSNN._chunk_step))
    out = tiny_run(cell)
    assert out["correct"] is False
    assert out["checks"]["diverged_decided_pct"]["value"] > LIMITS[cell]
