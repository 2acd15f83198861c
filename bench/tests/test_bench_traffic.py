"""The traffic generator and the feeds, on a fake loop with a fake
clock: lengths and arrivals, nearest-rank percentiles, latency from the
scheduled arrival, the standing backlog and the sample."""

import collections
import itertools

import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the checkout on the path)

from bench import drive, traffic
from bench.devtrace import Spans
from bench.reference import data


def test_nearest_rank():
    xs = [10.0, 20.0, 30.0, 40.0]
    assert traffic.nearest_rank(xs, 50) == 20.0
    assert traffic.nearest_rank(xs, 95) == 40.0
    assert traffic.nearest_rank([7.0], 1) == 7.0
    assert traffic.nearest_rank(range(1, 101), 95) == 95.0
    with pytest.raises(ValueError):
        traffic.nearest_rank([], 50)
    with pytest.raises(ValueError):
        traffic.nearest_rank(xs, 101)


def test_lengths_are_one_multiset_in_each_seeds_order():
    a = data.lengths(1000, 150, 500, 1)
    b = data.lengths(1000, 150, 500, 2 ** 31 + 5)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() == 150 and a.max() == 500
    assert abs(a.mean() - 325) < 1.0
    assert np.array_equal(a, data.lengths(1000, 150, 500, 1))


def test_arrivals():
    a = traffic.arrival_offsets(400.0, 10.0, 3, 1)
    b = traffic.arrival_offsets(400.0, 10.0, 4, 1)
    assert len(a) == len(b) == 4000
    assert a[0] == 0.0 and a[-1] < 10.0 and np.all(np.diff(a) > 0)
    gaps = np.diff(np.append(a, 10.0))
    # one multiset of gaps, in each seed's order
    assert np.allclose(sorted(gaps), sorted(np.diff(np.append(b, 10.0))))
    assert not np.array_equal(a, b)
    assert gaps.mean() == pytest.approx(1 / 400.0)
    # exponential: the median gap is ln 2 of the mean
    assert np.median(gaps) == pytest.approx(np.log(2) / 400.0, rel=0.02)
    assert not np.array_equal(a, traffic.arrival_offsets(400.0, 10.0, 3, 0))


def test_submission_order_cycles_the_pool():
    order = traffic.submission_order(5, 9)
    first = list(itertools.islice(order, 10))
    assert sorted(first[:5]) == list(range(5))
    assert sorted(first[5:]) == list(range(5))


class Req:
    def __init__(self, sid, frames):
        self.sid, self.frames = sid, frames
        self.t_harvest = None

    def stacked_logits(self):
        return np.full((len(self.frames), 2), float(self.sid), np.float32)


class FakeLoop:
    """Slots advanced ``chunk`` frames a step; a step takes ``step_s`` on
    the fake clock (``stall`` replaces it once); a request is harvested at
    the end of the step that completes it."""

    def __init__(self, slots=2, chunk=4, step_s=0.01):
        self.now = 0.0
        self.slots, self.chunk, self.step_s = slots, chunk, step_s
        self.queue = collections.deque()
        self.finished = []
        self.slot = [None] * slots
        self.pos = [0] * slots
        self.sid = 0
        self.stall = None
        self.steps = 0

    def clock(self):
        return self.now

    def submit(self, frames):
        self.queue.append(Req(self.sid, frames))
        self.sid += 1
        return self.sid - 1

    @property
    def has_work(self):
        return bool(self.queue) or any(self.slot)

    pending_steps = 0

    def step_once(self):
        for i in range(self.slots):
            if self.slot[i] is None and self.queue:
                self.slot[i], self.pos[i] = self.queue.popleft(), 0
        if not any(self.slot):
            return False
        self.now += self.stall if self.stall is not None else self.step_s
        self.stall = None
        self.steps += 1
        for i, r in enumerate(self.slot):
            if r is None:
                continue
            self.pos[i] += self.chunk
            if self.pos[i] >= len(r.frames):
                r.t_harvest = self.now
                self.finished.append(r)
                self.slot[i] = None
        return True


class Pool:
    def __init__(self, lens):
        self.lens = lens

    def __len__(self):
        return len(self.lens)

    def utterance(self, k):
        return np.zeros((self.lens[k], 1), np.float32)


def test_backlog_keeps_the_queue_full_and_samples_the_window():
    loop = FakeLoop(slots=4)
    col = drive.Collector(loop, 5, 1)
    got = []
    col.on_harvest = got.append
    win = {}
    col.counts = lambda r: bool(win) and win["t0"] <= r.t_harvest <= win["t1"]
    d = drive.Backlog({"backlog": 6}, loop, Pool([8] * 10),
                      traffic.submission_order(10, 1), col, Spans(False))
    d.warm(3)
    assert len(loop.queue) >= 6 - 4

    def opened(t0, t1):
        win.update(t0=t0, t1=t1)

    t0, t1 = d.window(0.2, opened, lambda: None)
    assert t1 == pytest.approx(t0 + 0.2)
    assert len(loop.queue) >= 2
    assert loop.steps >= 23
    assert col.seen == sum(1 for r in got if t0 <= r.t_harvest <= t1) > 5
    assert len(col.sample) == 5
    assert all(d.sid_utt[sid] < 10 for sid, _ in col.sample)
    assert d.step_s >= 0.0


class Served:
    """A harvested request whose logit rows view the blocks they came in."""

    def __init__(self, sid, frames, blocks):
        self.sid, self.frames, self.t_harvest = sid, frames, 0.0
        self.logits = [row for b in blocks for row in b]

    def stacked_logits(self):
        return np.stack(self.logits) if self.logits else np.zeros((0, 3))


def test_sample_copies_each_answer_once_and_keeps_misshapen_ones():
    class Loop:
        finished = []

        class engine:  # noqa: N801
            class cfg:  # noqa: N801
                fc_dim = 3

    col = drive.Collector(Loop, 4, 1, max_frames=5)
    rng = np.random.default_rng(0)
    block = rng.random((6, 3)).astype(np.float32)
    two = [rng.random((2, 3)).astype(np.float32) for _ in range(2)]
    reqs = [Served(0, np.zeros((4, 1)), [block[:4]]),  # one block
            Served(1, np.zeros((4, 1)), two),  # two blocks
            Served(2, np.zeros((5, 1)), [block[:4]]),  # a row short
            Served(3, np.zeros((4, 1)), [block[:4]])]
    for r in reqs:
        col._offer(r)
    got = dict(col.sample)
    assert np.array_equal(got[0], block[:4]) and got[0].base is col.buf
    assert np.array_equal(got[1], np.concatenate(two))
    assert got[2].shape == (4, 3)  # compared as misshapen, not padded
    block[0] = -1.0  # the copy does not alias the program's block
    assert not np.array_equal(got[3][0], block[0])


def test_open_loop_latency_runs_from_the_scheduled_arrival(monkeypatch):
    loop = FakeLoop(slots=8, chunk=4, step_s=0.01)
    monkeypatch.setattr(drive.time, "sleep",
                        lambda s: setattr(loop, "now", loop.now + s + 1e-6))
    col = drive.Collector(loop, 100, 1)
    d = drive.OpenLoop({"rate": 50.0}, loop, Pool([4] * 20),
                       traffic.submission_order(20, 1), col, Spans(False))
    lat = {}
    col.on_harvest = lambda r: lat.__setitem__(r.sid, r.t_harvest - d.due[r.sid]) \
        if r.sid in d.due else None
    col.counts = lambda r: r.sid in d.due
    offsets = np.array([0.0, 0.1, 0.2, 0.3])
    marks = []
    # a one-off stall of 0.35 s on the first step after the window opens
    t0, t1 = d.run(np.array([0.0]), offsets, 0.05, 0.4, 5.0,
                   lambda a, b: (marks.append(("open", a, b)),
                                 setattr(loop, "stall", 0.35)),
                   lambda: marks.append(("close", loop.now)))
    assert marks[0] == ("open", t0, t1) and marks[1][0] == "close"
    assert len(d.due) == 4 and len(lat) == 4
    assert sorted(d.due.values()) == pytest.approx(list(t0 + offsets))
    # the first window arrival waits out the stall; so do those due
    # during it, each counted from when it was due, not when it went in
    first = min(d.due, key=d.due.get)
    assert lat[first] >= 0.35
    by_due = sorted(d.due, key=d.due.get)
    assert lat[by_due[1]] >= 0.35 - 0.1 - 1e-9
    assert max(d.late_s) >= 0.2
    assert col.seen == 4


def test_open_loop_counts_a_request_never_harvested():
    class Stuck(FakeLoop):
        def step_once(self):
            self.now += self.step_s
            return True

    loop = Stuck()
    col = drive.Collector(loop, 4, 1)
    d = drive.OpenLoop({"rate": 10.0}, loop, Pool([4] * 4),
                       traffic.submission_order(4, 1), col, Spans(False))
    t0, t1 = d.run(np.array([]), np.array([0.0, 0.05]), 0.0, 0.1, 0.5,
                   lambda a, b: None, lambda: None)
    assert len(d.due) == 2 and loop.now >= t1 + 0.5
