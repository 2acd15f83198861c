"""The control of the check that decides ``correct``, run apart from the
benchmark's runs:

    python3 bench/control.py --workload <name> --seeds 1,2,3 [--streams 512]

For each seed it draws the cell's model and feature pool as a run does,
puts the reference computed one precision below the configuration's (TF32
weights, float32 sums: ``reference/model.py``'s ``"tf32"``) in the
program's place over ``--streams`` of the pool's utterances, and holds its
logits against the float64 reference with the run's own comparison.  It
prints one line a seed with ``diverged_decided_pct`` (the control's reading,
which the cell's limit must lie below) and, last, a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":  # the checkout's root heads the path, as in run.py
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402


def control_reading(cfg: dict, mix: dict, seed: int, streams: int,
                    device) -> dict:
    from bench import traffic
    from bench.reference import compare, data
    from bench.reference.model import Reference

    model = data.weights(cfg, seed, device)
    pool = traffic.Pool(mix, cfg, seed, device)
    scale = data.input_scale(pool.frames, cfg["input_bits"])
    rng = np.random.default_rng([int(seed) % 2 ** 63, 6])
    picks = rng.choice(len(pool), size=min(streams, len(pool)),
                       replace=False)
    xs = [pool.utterance(int(k)) for k in picks]
    low = Reference(cfg, model, "tf32", device)
    served = [np.zeros((len(x), cfg["fc_dim"]), np.float32) for x in xs]
    for t, live, logits, _, _ in low.frames(xs, scale):
        rows = logits.to(torch.float32).cpu().numpy()
        for i in np.flatnonzero(live.cpu().numpy()):
            served[i][t] = rows[i]
    return compare.compare(Reference(cfg, model, "exact", device), xs,
                           served, scale)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--streams", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench import harness

    _, cfg, mix, limits = harness.cell_files(harness.manifest(),
                                             args.workload)
    if cfg.get("family") != "rsnn":
        raise SystemExit(f"{args.workload}: the control is the RSNN "
                         f"reference's, not the {cfg.get('family')} family's")
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = control_reading(cfg, mix, seed, args.streams,
                            torch.device(args.device))
        readings.append(r["diverged_decided_pct"])
        print(f"seed {seed}: diverged_decided_pct "
              f"{r['diverged_decided_pct']} ({r['diverged_streams']} of "
              f"{r['checked_streams']} streams, {r['decided_frames']} of "
              f"{r['checked_frames']} frames decided) limit "
              f"{limits['diverged_decided_pct']}", flush=True)
    print(json.dumps({"workload": args.workload, "control": readings,
                      "min": min(readings)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
