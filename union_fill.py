#!/usr/bin/env python3
"""Union-list lengths of K10's candidate list groupings on served spikes.

    python3 union_fill.py [--seed 0] [--streams 512]

K10 (``csrc/spike_cell.cu``) runs its recurrent product over union event
lists: ``kUnionLists`` = 4 spike lists share one list of indices, and each
union entry costs one W read and one fmaf for each list.  Which lists
share a union decides how long the unions are.  This script serves
``--streams`` seeded utterances through the ``spike`` backend over
``chip_smoke.py``'s ``csc`` artifact with the plain versions on the CPU,
records every K10 call's spike trains (TS = 2, B = 256 slots, H = 128)
and prints, per call site (L0, L1), the mean union length of:

* ``2 rows x 2 steps``: the TS steps of two neighbouring rows (K10's
  grouping);
* ``4 rows, one step``: four neighbouring rows at the same step (K9's
  grouping over rows);
* ``4 rows x 2 steps``: eight lists in one union;
* ``one list``: a list's own events.

It needs no GPU and times nothing: the lengths are counts.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

GROUPINGS = ("2 rows x 2 steps", "4 rows, one step", "4 rows x 2 steps",
             "one list")


def union_lengths(s: torch.Tensor) -> dict[str, float]:
    """Mean union length of each grouping over the (TS, B, H) trains ``s``,
    groups of four neighbouring rows (B a multiple of 4)."""
    ts, b, h = s.shape
    live = (s != 0).reshape(ts, b // 4, 4, h)  # (ts, group, row, h)
    pairs = live.reshape(ts, b // 4, 2, 2, h).any(dim=0).any(dim=2)
    return {
        "2 rows x 2 steps": float(pairs.sum(dim=-1).float().mean()),
        "4 rows, one step": float(live.any(dim=2).sum(dim=-1).float().mean()),
        "4 rows x 2 steps": float(live.any(dim=0).any(dim=1).sum(dim=-1)
                                  .float().mean()),
        "one list": float(live.sum(dim=-1).float().mean())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streams", type=int, default=chip_smoke.STREAMS)
    args = ap.parse_args(argv)
    from repro_torch.core.artifact import load_artifact
    from repro_torch.kernels import ops
    from repro_torch.serving.stream import CompiledRSNN, EngineConfig

    calls: list[torch.Tensor] = []
    plain = ops.spike_cell

    def recorded(stim_base, s_prev, *rest, **kw):
        calls.append(s_prev.clone())
        return plain(stim_base, s_prev, *rest, **kw)

    ops.spike_cell = recorded
    torch.cuda.synchronize = lambda *a, **k: None  # serve() syncs the card
    utts = chip_smoke.utterances(args.seed, args.streams)
    with tempfile.TemporaryDirectory() as tmp:
        path = chip_smoke.write_artifact(Path(tmp) / "csc", args.seed, utts,
                                         prune=0.4, fc_layout="csc")
        art = load_artifact(path)
        eng = CompiledRSNN.from_artifact(path, EngineConfig(
            backend="spike", precision=art.precision,
            input_scale=art.input_scale), device="cpu")
        loop, _, _ = chip_smoke.serve(eng, utts)
    h = calls[0].shape[-1]
    print(f"{len(calls)} K10 calls over {loop.steps} steps, B = "
          f"{calls[0].shape[1]}, H = {h}, TS = {calls[0].shape[0]}")
    for site, trains in (("L0", calls[0::2]), ("L1", calls[1::2])):
        per = [union_lengths(s) for s in trains]
        for g in GROUPINGS:
            mean = float(np.mean([p[g] for p in per]))
            print(f"{site} {g}: {mean!r} union entries of H = {h}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
