"""The RSNN family: the paper's recurrent spiking network served by the
port's slot loop (``StreamLoop``), held against the plain RSNN reference.

Set-up draws the model and the feature pool from the seed on the card,
writes the artifact and builds the program (``program.py``); ``serve``
warms the loop up and serves the mix for the window (``drive.py``); the
check holds a seeded sample of the window's answers against the reference
(``reference/``).  The mix is ``"mode": "backlog"`` (a standing backlog,
``frames_per_s``) or ``"mode": "open"`` (Poisson arrivals,
``completion_p95_ms``).
"""

from __future__ import annotations

import shutil
import sys
import tempfile
from pathlib import Path

from bench import drive, traffic
from bench.reference import compare, data
from bench.reference.model import Reference

MODES = ("backlog", "open")
# the mix's keys this family reads, in every mode and in each
MIX_KEYS = ("slots", "chunk_frames", "pipeline_depth", "ring_frames",
            "min_frames", "max_frames", "pool", "check")
MODE_KEYS = {"backlog": ("backlog", "warmup_dispatches"),
             "open": ("rate", "warmup_s", "drain_s")}


def check_mix(mix: dict) -> None:
    """Raise ``ValueError`` for a mix this family cannot serve."""
    if mix.get("mode") not in MODES:
        raise ValueError(f"rsnn traffic: mode {mix.get('mode')!r} not in "
                         f"{MODES}")
    missing = [k for k in MIX_KEYS + MODE_KEYS[mix["mode"]] if k not in mix]
    if missing:
        raise ValueError(f"rsnn traffic ({mix['mode']}) lacks {missing}")


class Setup:
    """The drawn model and feature pool, the input scale, and the program
    (``program``: the slot loop over the engine)."""

    def __init__(self, cfg, mix, seed, model, pool, scale, program):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.model, self.pool, self.scale = model, pool, scale
        self.program = program


def build(cfg: dict, mix: dict, seed: int, device, timeline) -> Setup:
    check_mix(mix)
    model = data.weights(cfg, seed, device)
    pool = traffic.Pool(mix, cfg, seed, device)
    scale = data.input_scale(pool.frames, cfg["input_bits"])
    timeline.phase("weights_pool")
    workdir = Path(tempfile.mkdtemp(prefix="bench-"))
    try:
        from bench import program

        path = program.write_artifact(workdir / "artifact", cfg, model,
                                      scale)
        timeline.phase("artifact")
        loop = program.load(path, mix, device)
        timeline.phase("engine_capture")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return Setup(cfg, mix, seed, model, pool, scale, loop)


def fc_entries(cfg: dict, model: dict) -> int:
    """CSC entries a column of the stored FC (the densest column's kept
    count, which the layout pads every column to); 0 for a dense FC."""
    if cfg["precision"] != "int4":
        return 0
    keep = model["layers"]["fc_w"][2]
    return max(int(keep.sum(dim=0).max()), 1)


class Served:
    """What the window measured: the window, the loop's counters at its
    bounds, every harvested request's (t_harvest, frames), and in the open
    loop each due request's completion latency; once ``serve`` returns,
    the end-to-end values, the counts and the check's sample."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.open: dict = {}
        self.close: dict = {}
        self.harvests: list[tuple[float, int]] = []
        self.latency: dict[int, float] = {}  # open loop: sid -> seconds
        self.e2e: dict = {}
        self.attempted = self.failed = 0
        self.sample: list = []  # (sid, logits)
        self.sid_utt: dict[int, int] = {}
        self.macs_per_frame = 0.0  # the reference's, set by ``check``

    def in_window(self, t: float) -> bool:
        return self.t0 is not None and self.t0 <= t <= self.t1

    def frames(self) -> int:
        return sum(n for t, n in self.harvests if self.in_window(t))

    def frames_by_second(self) -> list[int]:
        """Frames harvested in each whole second of the window."""
        out = [0] * max(1, int(self.t1 - self.t0))
        for t, n in self.harvests:
            if self.in_window(t):
                out[min(int(t - self.t0), len(out) - 1)] += n
        return out


def serve(setup: Setup, window, spans, timeline) -> Served:
    """Warm up (the open loop: with ``warmup_s`` of arrivals), settle, then
    serve the mix over ``window.seconds``; set-up ends as the window opens
    (``Served.t0``)."""
    loop, mix, seed = setup.program, setup.mix, setup.seed
    seconds = window.seconds
    collector = drive.Collector(loop, mix["check"], seed, mix["max_frames"])
    order = traffic.submission_order(len(setup.pool), seed)
    got = Served()
    cls = drive.Backlog if mix["mode"] == "backlog" else drive.OpenLoop
    feed = cls(mix, loop, setup.pool, order, collector, spans)

    def counters() -> dict:
        return {"dispatches": loop.dispatches, "host_syncs": loop.host_syncs,
                "frames_served": loop.frames_served,
                "step_s": feed.step_s}

    def on_open(t0, t1):
        got.t0, got.t1 = t0, t1
        window.open(t0, t1)
        got.open = counters()

    def on_close():
        got.close = counters()
        window.close()

    if mix["mode"] == "backlog":
        collector.on_harvest = lambda r: got.harvests.append(
            (r.t_harvest, len(r.frames)))
        collector.counts = lambda r: got.in_window(r.t_harvest)
        rate = feed.warm(mix["warmup_dispatches"])
        collector.stride_for(rate * seconds)
        timeline.phase("warmup")
        window.settle()
        feed.window(seconds, on_open, on_close)
    else:
        def harvest(r):
            got.harvests.append((r.t_harvest, len(r.frames)))
            if r.sid in feed.due:
                got.latency[r.sid] = r.t_harvest - feed.due[r.sid]

        collector.on_harvest = harvest
        collector.counts = lambda r: r.sid in feed.due
        warm = traffic.arrival_offsets(mix["rate"], mix["warmup_s"], seed, 0)
        offs = traffic.arrival_offsets(mix["rate"], seconds, seed, 1)
        collector.stride_for(len(offs))
        window.settle()
        feed.run(warm, offs, mix["warmup_s"], seconds, mix["drain_s"],
                 on_open, on_close)
    loop.flush()
    collector.poll()

    got.sample = collector.sample
    got.sid_utt = feed.sid_utt
    if mix["mode"] == "backlog":
        got.attempted = sum(1 for t, _ in got.harvests if got.in_window(t))
        got.e2e = {"frames_per_s": got.frames() / seconds}
    else:
        lat = open_loop_latencies(got, feed, mix)
        got.attempted = len(feed.due)
        got.failed = got.attempted - len(got.latency)
        got.e2e = {"completion_p95_ms": 1e3 * traffic.nearest_rank(lat, 95)}
        late = feed.late_s or [0.0]
        print(f"open loop: {got.attempted} due, {got.failed} not harvested "
              f"by the drain's end; completion p50 "
              f"{1e3 * traffic.nearest_rank(lat, 50):.3f} ms p95 "
              f"{got.e2e['completion_p95_ms']:.3f} ms; generator late p50 "
              f"{1e3 * traffic.nearest_rank(late, 50):.3f} ms max "
              f"{1e3 * max(late):.3f} ms", file=sys.stderr)
    print(f"frames harvested in each second of the window: "
          f"{got.frames_by_second()}", file=sys.stderr)
    return got


def open_loop_latencies(got: Served, feed, mix: dict) -> list[float]:
    """Completion latency (s) of every due request, from its scheduled
    arrival to its harvest; one not harvested by the drain's end counts
    from its arrival to that end."""
    end = got.t1 + mix["drain_s"]
    return [got.latency.get(sid, end - due)
            for sid, due in feed.due.items()]


def check(setup: Setup, got: Served, limits: dict, device
          ) -> tuple[dict, bool, int]:
    """The window's sample against the float64 reference: the share of
    decided frames (before a stream's first threshold tie) that diverged,
    the streams missing from the sample, and how many were checked, each
    with its limit."""
    streams = [setup.pool.utterance(got.sid_utt[sid]) for sid, _ in got.sample]
    served = [logits for _, logits in got.sample]
    ref = Reference(setup.cfg, setup.model, "exact", device)
    cmp = compare.compare(ref, streams, served, setup.scale)
    got.macs_per_frame = cmp["macs_per_frame"]
    checks = {
        "diverged_decided_pct": {"value": cmp["diverged_decided_pct"],
                                 "limit": limits["diverged_decided_pct"]},
        "missing_streams": {"value": cmp["missing_streams"], "limit": 0},
        "checked_streams": {"value": cmp["checked_streams"],
                            "limit": limits["min_checked_streams"]},
    }
    correct = (cmp["diverged_decided_pct"] <= limits["diverged_decided_pct"]
               and cmp["missing_streams"] == 0
               and cmp["checked_streams"] >= limits["min_checked_streams"])
    print(f"checked {cmp['checked_streams']} streams, "
          f"{cmp['checked_frames']} frames; {cmp['diverged_streams']} "
          f"streams diverged ({cmp['diverged_frames_pct']}% of the frames); "
          f"{cmp['tied_streams']} streams reached a threshold tie, "
          f"{cmp['decided_frames']} frames decided", file=sys.stderr)
    return checks, correct, got.failed + cmp["missing_streams"]


def context(setup: Setup, got: Served) -> dict:
    return {"cfg": setup.cfg, "mix": setup.mix,
            "open": got.open, "close": got.close,
            "macs_per_frame": got.macs_per_frame,
            "fc_entries": fc_entries(setup.cfg, setup.model)}
