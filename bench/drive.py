"""Driving the slot loop: a standing backlog or an open loop of arrivals.

Both feeds step ``StreamLoop`` through its public interface
(``submit``, ``step_once``, ``finished``, ``queue``, ``flush``) and time
on its clock.  A request counts when its logits reached the host: its
``t_harvest``, which the loop stamps when it retires the step that
completed it.  Harvested requests leave the loop's ``finished`` list as
they come; those the check compares (a seeded reservoir sample of the
window's requests) keep their logits, the others drop them, so the host
holds a few blocks of logits and not a run's worth.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from bench.devtrace import Spans


def _rows_block(req):
    """The array whose first rows the request's logit rows are, in order
    (its harvest copied them into one block), or None where they are
    not."""
    rows = req.logits
    if not rows:
        return None
    base = rows[0].base
    if not (isinstance(base, np.ndarray) and base.ndim == 2
            and base.flags.c_contiguous and rows[-1].base is base
            and len(rows) <= base.shape[0]):
        return None
    p0 = base.__array_interface__["data"][0]
    last = p0 + (len(rows) - 1) * base.strides[0]
    if rows[0].__array_interface__["data"][0] != p0 or \
            rows[-1].__array_interface__["data"][0] != last:
        return None
    return base[:len(rows)]


class Collector:
    """Takes harvested requests off the loop, and keeps with their logits
    a systematic sample of those ``counts`` accepts: every ``stride``-th
    from a seeded offset, at most ``size``.  The stride spreads the
    sample's copies evenly over the window (``stride_for``); each is one
    copy into a buffer written through at set-up, so the window pays no
    page faults for it."""

    def __init__(self, loop, size: int, seed: int, max_frames: int = 0):
        self.loop = loop
        self.size = size
        self.buf = np.empty((size, max_frames, loop.engine.cfg.fc_dim)
                            if max_frames else (0, 0, 0), np.float32)
        self.buf.fill(0.0)
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 5])
        self.stride, self.offset = 1, 0
        self.waiting: collections.deque = collections.deque()
        self.seen = 0  # accepted requests
        self.seen_all = 0  # harvested requests
        self.sample: list = []  # (sid, logits (T, fc_dim))
        self.counts = lambda req: False
        self.on_harvest = lambda req: None

    def stride_for(self, expected: float) -> None:
        """Sample ``size`` of about ``expected`` accepted requests."""
        self.stride = max(1, int(expected // self.size))
        self.offset = int(self.rng.integers(0, self.stride))

    def poll(self) -> None:
        if self.loop.finished:
            self.waiting.extend(self.loop.finished)
            self.loop.finished.clear()
        while self.waiting and self.waiting[0].t_harvest is not None:
            req = self.waiting.popleft()
            self.seen_all += 1
            self.on_harvest(req)
            if self.counts(req):
                self._offer(req)

    def _offer(self, req) -> None:
        k = self.seen
        self.seen += 1
        if k % self.stride != self.offset or len(self.sample) >= self.size:
            return
        n = len(req.frames)
        block = _rows_block(req) if n <= self.buf.shape[1] else None
        if block is None or len(block) != n:
            self.sample.append((req.sid, req.stacked_logits()))
            return
        dst = self.buf[len(self.sample), :n]
        np.copyto(dst, block)
        self.sample.append((req.sid, dst))


class Feed:
    """What both modes share: the pool, the submission order, the host
    time inside ``step_once`` and the spans."""

    def __init__(self, loop, pool, order, collector: Collector,
                 spans: Spans):
        self.loop = loop
        self.pool = pool
        self.order = order
        self.collector = collector
        self.spans = spans
        self.sid_utt: dict[int, int] = {}
        self.step_s = 0.0

    def submit_next(self) -> int:
        k = next(self.order)
        sid = self.loop.submit(self.pool.utterance(k))
        self.sid_utt[sid] = k
        return sid

    def step(self) -> bool:
        t = time.time_ns()
        a = time.perf_counter()
        went = self.loop.step_once()
        self.step_s += time.perf_counter() - a
        self.spans.add("step_once", t)
        t = time.time_ns()
        self.collector.poll()
        self.spans.add("collect", t)
        return went


class Backlog(Feed):
    """A closed loop over a standing backlog: the queue is topped up to
    ``backlog`` streams before every dispatch, so every slot is refilled
    the moment it frees."""

    def __init__(self, mix: dict, *args):
        super().__init__(*args)
        self.backlog = mix["backlog"]

    def top_up(self) -> None:
        t = time.time_ns()
        while len(self.loop.queue) < self.backlog:
            self.submit_next()
        self.spans.add("submit", t)

    def warm(self, dispatches: int) -> float:
        """Serve ``dispatches`` dispatches; returns the streams harvested
        a second over their second half."""
        half, done, t = dispatches // 2, 0, None
        for k in range(dispatches):
            if k == half:
                t = self.loop.clock()
                done = self.collector.seen_all
            self.top_up()
            self.step()
        dt = self.loop.clock() - t
        return (self.collector.seen_all - done) / dt if dt > 0 else 0.0

    def window(self, seconds: float, on_open, on_close) -> tuple[float, float]:
        """Serve for ``seconds`` on the loop's clock, calling ``on_open(t0,
        t1)`` as the window opens and ``on_close()`` as it closes; returns
        (t0, t1)."""
        clock = self.loop.clock
        t0 = clock()
        t1 = t0 + seconds
        on_open(t0, t1)
        while clock() < t1:
            self.top_up()
            self.step()
        on_close()
        return t0, t1


class OpenLoop(Feed):
    """An open loop: each stream is submitted once its scheduled arrival
    time has come, whatever the loop is doing; between arrivals the loop
    steps while it has work.  Latency runs from the scheduled arrival, so
    a stall charges every arrival it delays."""

    def __init__(self, mix: dict, *args):
        super().__init__(*args)
        self.rate = mix["rate"]
        self.due: dict[int, float] = {}  # sid -> scheduled arrival (s)
        self.late_s: list[float] = []  # submission minus scheduled arrival

    def run(self, warm_offsets, offsets, warmup_s: float, seconds: float,
            drain_s: float, on_open, on_close) -> tuple[float, float]:
        """Warm-up arrivals over ``warmup_s``, then the window's over
        ``seconds`` (those are due), then serve until every due request is
        harvested or ``drain_s`` has passed; ``on_open(t0, t1)`` and
        ``on_close()`` mark the window.  Returns the window (t0, t1)."""
        clock = self.loop.clock
        start = clock()
        t0 = start + warmup_s
        t1 = t0 + seconds
        sched = np.concatenate([start + np.asarray(warm_offsets),
                                t0 + np.asarray(offsets)])
        due_from = len(warm_offsets)
        i, n = 0, len(sched)
        opened = closed = False
        deadline = t1 + drain_s
        harvested = set()
        inner = self.collector.on_harvest

        def mark(req):
            if req.sid in self.due:
                harvested.add(req.sid)
            inner(req)

        self.collector.on_harvest = mark
        try:
            while True:
                now = clock()
                if not opened and now >= t0:
                    opened = True
                    on_open(t0, t1)
                if i < n and sched[i] <= now:
                    t = time.time_ns()
                    while i < n and sched[i] <= now:
                        sid = self.submit_next()
                        if i >= due_from:
                            self.due[sid] = float(sched[i])
                            self.late_s.append(now - float(sched[i]))
                        i += 1
                    self.spans.add("submit", t)
                if i >= n and len(harvested) == len(self.due):
                    break
                if now >= deadline:
                    break
                if self.loop.has_work or self.loop.pending_steps:
                    self.step()
                elif i < n:
                    t = time.time_ns()
                    time.sleep(max(0.0, min(sched[i] - clock(), 5e-4)))
                    self.spans.add("wait_arrival", t)
                else:
                    break
                if not closed and opened and clock() >= t1:
                    closed = True
                    on_close()
        finally:
            self.collector.on_harvest = inner
        if not opened:
            on_open(t0, t1)
        if not closed:
            on_close()
        return t0, t1
