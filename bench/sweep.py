"""The sweep that fixed an open-loop mix's arrival rate, run once on the
card and kept for the record:

    python3 bench/sweep.py --workload <open cell> --seed <n> \\
        [--probe-seconds 6] [--rates 2000,4000,...] [--bisect 3]

It builds the cell's program as a run does, measures the loop's service
rate under a standing backlog of the same utterances, then offers Poisson
arrivals at each probe rate for ``--probe-seconds`` and reads the queue
of streams waiting for a slot at the middle and at the end of the
arrivals.  A probe is sustained when the queue at the end is no longer
than at the middle, or than a sixteenth of the slots (a few dispatches'
refills, which a Poisson burst brings at any rate below capacity): a
queue that grows through the probe means arrivals outrun service.  (At 2048 slots this can fail: once every slot is busy,
the arrivals a dispatch brings beyond the finishes it makes wait in the
queue.)  After the listed probes it bisects between the highest sustained
and the lowest unsustained rate.  The last line is a JSON summary, with
0.8 of the highest sustained rate; ``PERF.md`` says which rate the mix
took from the sweeps and why.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":  # the checkout's root heads the path, as in run.py
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402


def drain(loop) -> None:
    while loop.step_once():
        loop.finished.clear()
    loop.flush()
    loop.finished.clear()


def service_rate(loop, pool, order, seconds: float, backlog: int) -> float:
    """Streams harvested a second under a standing backlog."""
    done, t0 = 0, loop.clock()
    while loop.clock() - t0 < seconds:
        while len(loop.queue) < backlog:
            loop.submit(pool.utterance(next(order)))
        loop.step_once()
        done += len(loop.finished)
        loop.finished.clear()
    rate = done / (loop.clock() - t0)
    loop.queue.clear()
    drain(loop)
    return rate


def probe(loop, pool, order, rate: float, seconds: float, seed: int
          ) -> dict:
    from bench import traffic

    offs = traffic.arrival_offsets(rate, seconds, seed, 2)
    clock = loop.clock
    start = clock()
    sched = start + offs
    mid, end = start + seconds / 2, start + seconds
    q_mid = q_end = None
    due: dict[int, float] = {}
    lat: list[float] = []
    i = 0
    while i < len(sched) or loop.has_work or loop.pending_steps:
        now = clock()
        while i < len(sched) and sched[i] <= now:
            due[loop.submit(pool.utterance(next(order)))] = sched[i]
            i += 1
        if q_mid is None and now >= mid:
            q_mid = len(loop.queue)
        if q_end is None and now >= end:
            q_end = len(loop.queue)
            if q_end > 4 * (q_mid + 1) and q_end > loop.slots:
                break  # plainly unsustained: no need to serve the rest
        if loop.has_work or loop.pending_steps:
            loop.step_once()
        else:
            time.sleep(max(0.0, min(sched[i] - clock(), 5e-4)))
        for r in loop.finished:
            if r.t_harvest is not None and r.sid in due:
                lat.append(r.t_harvest - due[r.sid])
        loop.finished[:] = [r for r in loop.finished if r.t_harvest is None]
    loop.queue.clear()
    drain(loop)
    q_end = len(loop.queue) if q_end is None else q_end
    return {"rate": rate, "queue_mid": q_mid, "queue_end": q_end,
            "sustained": q_end <= max(q_mid, loop.slots // 16),
            "completion_p95_ms": (1e3 * traffic.nearest_rank(lat, 95)
                                  if lat else None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--probe-seconds", type=float, default=6.0)
    p.add_argument("--rates", default="")
    p.add_argument("--bisect", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench import harness, traffic
    from bench.families import rsnn

    _, cfg, mix, _ = harness.cell_files(harness.manifest(), args.workload)
    if cfg.get("family") != "rsnn":
        raise SystemExit(f"{args.workload}: the sweep drives the RSNN slot "
                         f"loop, not the {cfg.get('family')} family")
    dev = torch.device(args.device)
    setup = rsnn.build(cfg, mix, args.seed, dev,
                       harness.Timeline(time.monotonic()))
    loop, pool = setup.program, setup.pool
    order = traffic.submission_order(len(pool), args.seed)
    service_rate(loop, pool, order, 2.0, mix["slots"])  # warm-up
    service = service_rate(loop, pool, order, args.probe_seconds,
                           mix["slots"])
    print(f"service rate under a backlog: {service:.1f} streams/s",
          flush=True)
    rates = ([float(r) for r in args.rates.split(",")] if args.rates else
             [round(f * service, 1) for f in (0.6, 0.8, 0.9, 1.0, 1.1)])
    probes = []
    for r in rates:
        probes.append(probe(loop, pool, order, r, args.probe_seconds,
                            args.seed))
        print(json.dumps(probes[-1]), flush=True)
    for _ in range(args.bisect):
        ok = [q["rate"] for q in probes if q["sustained"]]
        bad = [q["rate"] for q in probes if not q["sustained"]
               and q["rate"] > max(ok, default=0.0)]
        if not ok or not bad:
            break
        mid = round((max(ok) + min(bad)) / 2, 1)
        probes.append(probe(loop, pool, order, mid, args.probe_seconds,
                            args.seed))
        print(json.dumps(probes[-1]), flush=True)
    best = max((q["rate"] for q in probes if q["sustained"]), default=None)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "service_streams_per_s": service, "probes": probes,
                      "highest_sustained": best,
                      "rate_at_0.8": None if best is None
                      else round(0.8 * best, 1),
                      "device": (torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
