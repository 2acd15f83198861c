"""The slot loop's span readers (``bench/metrics/*_per_dispatch.py``,
``resets_per_finish.py``), their helpers (``bench/spanread.py``) and the
analysis of a traced run (``bench/slot_trace.py``) over hand-made records
in the program's span ring, a stub trace window with the loop's counters
at its bounds, and hand-made device operations."""

import collections
import importlib.util

import pytest

from bench_tiny import ROOT

from bench import slot_trace, spanread
from repro_torch.serving import spans

READERS = ("reset_host_ms_per_dispatch", "resets_per_finish",
           "harvest_host_ms_per_dispatch", "stage_host_ms_per_dispatch",
           "plan_host_ms_per_dispatch", "host_wait_ms_per_dispatch")
MS = 1_000_000  # ns
T0, T1 = 100 * MS, 200 * MS


def reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    def __init__(self, t0, t1):
        self.t0, self.t1 = t0, t1


def step(k: int, start: int, resets: int, finishes: int) -> list[tuple]:
    """Dispatch ``k``'s records from ``start`` (ns), 10 ms long: a reset
    of 1 ms at refill, a plan of 0.5 ms, a stage of 2 ms holding a 0.5 ms
    upload wait, a dispatch, a harvest of 0.25 ms and a reset of 1 ms at
    completion, a retire with a 0.75 ms fence wait and a 0.5 ms
    materialize; the root holds the counters at its end."""
    s = start
    return [
        ("loop.reset", s + 0, s + MS, k, 7, None),
        ("loop.refill", s + 0, s + MS, k, -1, None),
        ("loop.plan", s + MS, s + MS + MS // 2, k, -1, None),
        ("loop.wait_upload", s + 2 * MS, s + 2 * MS + MS // 2, k, -1, None),
        ("loop.stage", s + 2 * MS, s + 4 * MS, k, -1, None),
        ("loop.dispatch", s + 4 * MS, s + 5 * MS, k, -1, None),
        ("loop.harvest", s + 5 * MS, s + 5 * MS + MS // 4, k, 7, None),
        ("loop.reset", s + 6 * MS, s + 7 * MS, k, 7, None),
        ("loop.advance", s + 5 * MS, s + 7 * MS, k, -1, None),
        ("loop.wait_fence", s + 7 * MS, s + 7 * MS + 3 * MS // 4, k, -1,
         None),
        ("loop.materialize", s + 8 * MS, s + 8 * MS + MS // 2, k, 7, None),
        ("loop.retire", s + 7 * MS, s + 9 * MS, k, -1, None),
        ("loop.step", s, s + 10 * MS, k, -1, (k + 1, 0, resets, finishes)),
    ]


def ring(records, written=None):
    r = collections.deque(records, maxlen=spans.CAPACITY)
    return r, len(records) if written is None else written


@pytest.fixture
def window(monkeypatch):
    """Ten dispatches in the window (three resets and one finish each,
    after 4 resets and 2 finishes), one before it and one straddling its
    end; returns the readers' context."""
    recs = step(0, T0 - 20 * MS, 4, 2)  # before the window
    for k in range(1, 11):
        recs += step(k, T0 + (k - 1) * 10 * MS, 4 + 3 * k, 2 + k)
    recs += step(11, T1 - MS // 2, 40, 13)  # not inside
    r, n = ring(recs)
    monkeypatch.setattr(spans, "_ring", r)
    monkeypatch.setattr(spans, "_written", n)
    return {"trace": Window(T0, T1), "open": {"dispatches": 1},
            "close": {"dispatches": 11}}


@pytest.mark.parametrize("name, want", [
    ("reset_host_ms_per_dispatch", 2.0),
    ("harvest_host_ms_per_dispatch", 0.75),
    ("stage_host_ms_per_dispatch", 1.5),  # 2 ms less the 0.5 ms wait
    ("plan_host_ms_per_dispatch", 0.5),
    ("host_wait_ms_per_dispatch", 1.25),
    ("resets_per_finish", 3.0),  # (34 - 7) / (12 - 3) between the roots
])
def test_readers_over_the_window(window, name, want):
    assert reader(name)(window) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_dispatches(window, name):
    window["close"]["dispatches"] = window["open"]["dispatches"]
    assert reader(name)(window) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_records(monkeypatch, name):
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=8))
    monkeypatch.setattr(spans, "_written", 0)
    ctx = {"trace": Window(T0, T1), "open": {"dispatches": 0},
           "close": {"dispatches": 5}}
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_over_a_window_the_ring_dropped(window, monkeypatch,
                                                          name):
    # the ring dropped records, and its oldest kept one ends in the window
    kept = [r for r in spans._ring if r[2] >= T0 + 15 * MS]
    r, _ = ring(kept)
    monkeypatch.setattr(spans, "_ring", r)
    monkeypatch.setattr(spans, "_written", len(kept) + 30)
    assert reader(name)(window) is None


def test_a_ring_that_dropped_only_older_records_still_reads(window,
                                                            monkeypatch):
    kept = [r for r in spans._ring if r[1] >= T0 - 20 * MS + 5 * MS]
    r, _ = ring(kept)
    monkeypatch.setattr(spans, "_ring", r)
    monkeypatch.setattr(spans, "_written", len(kept) + 5)
    assert spans.dropped() == 5
    assert reader("reset_host_ms_per_dispatch")(window) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_for_a_program_without_spans(window, monkeypatch,
                                                       name):
    import sys

    import repro_torch.serving

    # a program without the spans module: the import fails
    monkeypatch.delattr(repro_torch.serving, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.serving.spans", None)
    assert reader(name)(window) is None


def rec(name, s, e, dispatch=0, sid=-1, counts=None):
    return spans.Span(name, s, e, dispatch, sid, counts)


def test_self_time_and_interval_names():
    recs = [rec(spans.STEP, 0, 100), rec(spans.STAGE, 10, 40),
            rec(spans.WAIT_UPLOAD, 20, 35), rec(spans.DISPATCH, 40, 50),
            rec(spans.RETIRE, 60, 100), rec(spans.WAIT_FENCE, 60, 95),
            rec(spans.STEP, 120, 150, dispatch=1)]
    assert spanread.self_ns(recs) == {
        spans.STEP: 100 - 30 - 10 - 40 + 30, spans.STAGE: 30 - 15,
        spans.WAIT_UPLOAD: 15, spans.DISPATCH: 10, spans.RETIRE: 5,
        spans.WAIT_FENCE: 35}
    assert spanread.total_ns(recs, spans.STAGE, spans.DISPATCH) == 40
    assert spanread.name_intervals(recs, [
        (15, 40),  # 10 of stage, 15 of its wait
        (0, 12),  # 10 of the root's own time, 2 of stage
        (55, 100),  # 5 of the root, 35 of the fence
        (100, 120),  # between the steps
        (110, 130),  # 10 of the next root
    ]) == [spans.WAIT_UPLOAD, spans.STEP, spans.WAIT_FENCE, "none",
           spans.STEP]


def test_gaps_uploads_and_launches():
    assert slot_trace.idle_gaps([(2, 4), (6, 9)], 0, 10) == [
        (0, 2), (4, 6), (9, 10)]
    assert slot_trace.idle_gaps([(0, 10)], 0, 10) == []
    # the nearest copy within reach, signed; a span with none is left out
    assert slot_trace.copy_lags([100 * MS, 200 * MS, 300 * MS],
                                [100 * MS + 60_000, 200 * MS - 2 * MS]) == [
        60_000, -2 * MS]
    disp = [0, 10, 20, 30, 40, 50]
    share, lags = slot_trace.launch_check([1, 12, 19, 55], disp, 1)
    # the third starts before its own span, the fourth two spans late
    assert share == 0.5 and lags == [1, 2, -1, 25]
    assert slot_trace.launch_check([1, 12, 19, 55], disp, 2)[0] == 0.75


@pytest.mark.parametrize("offset_ms", [0.0, -2.3, 1.7])
def test_a_traced_window_summarised_on_a_shifted_clock(window, offset_ms):
    """Each dispatch's upload 60 us and its K6 launch 1 ms after its span
    opened, on a device clock ``offset_ms`` off the host's: the uploads
    give the offset, and the shift restores the launches' lags and the
    gaps' names."""
    recs = spans.window(T0, T1)

    def summary(offset_ms):
        off = int(offset_ms * MS)
        ops = []
        for r in spans.records():
            if r.name == spans.DISPATCH:
                ops.append(("Memcpy HtoD (Pinned -> Device)",
                            r.start_ns + 60_000 + off,
                            r.start_ns + 70_000 + off))
                ops.append(("megastep_kernel<2, 2, false>",
                            r.start_ns + MS + off,
                            r.start_ns + MS + MS // 5 + off))
        return slot_trace.analyse(recs, ops, T0, T1, 10, 0.1, 2)

    got, true = summary(offset_ms), summary(0.0)
    assert got["root_ms"] == pytest.approx(10.0)
    assert got["step_ms"] == pytest.approx(10.0)
    assert got["self_ms"][spans.STAGE] == pytest.approx(1.5)
    assert got["count"][spans.RESET] == 2
    assert got["root_covered"] == pytest.approx(1 - 1.5 / 10)
    assert got["clock"]["shift_us"] == pytest.approx(60 + 1e3 * offset_ms)
    assert got["launches"]["n"] == got["launches"]["dispatch_spans"] == 10
    shifted = got["launches"]["shifted"]
    assert shifted["matched_share"] == 1.0
    assert shifted["lag_ms"]["median"] == pytest.approx(0.94)
    raw = got["launches"]["raw"]
    assert raw["lag_ms"]["median"] == pytest.approx(1 + offset_ms)
    assert raw["matched_share"] == (0.0 if offset_ms < -1 else 1.0)
    # the card idles from each launch's end to the next upload, 8.86 ms;
    # shifted, the gaps keep their names on the true clock (60 us off)
    assert [ms for _, ms in got["idle_top"][:9]] == pytest.approx([8.86] * 9)
    assert [n for n, _ in got["idle_top"]] == [n for n, _ in true["idle_top"]]
    assert set(got["idle_over_1ms_ms"]["shifted"]) <= set(spans.NAMES)
    assert got["idle_over_1ms_ms"]["shifted"].keys() == \
        true["idle_over_1ms_ms"]["raw"].keys()
