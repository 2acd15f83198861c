"""The slot loop's program spans (``repro_torch/serving/spans.py``) over a
traced run's window, and the sums taken of them: by the per-layer readers
in ``metrics/`` and by ``slot_trace.py``.

A record is the program's ``Span(name, start_ns, end_ns, dispatch, sid,
counts)``.  A program without the spans module, or a window the ring
holds nothing of or has dropped records of, reads as ``None``: a reader
then reports nothing rather than a truncated sum.
"""

from __future__ import annotations

from typing import Iterable


def window(ctx: dict) -> tuple[list, int] | None:
    """The records inside the traced window of the readers' context
    ``ctx`` and the loop's dispatches over it; ``None`` where the program
    records no spans, the window holds none, the ring dropped some of
    them, or the loop made no dispatch."""
    try:
        from repro_torch.serving import spans
    except ImportError:  # a program without spans
        return None
    recs = spans.window(ctx["trace"].t0, ctx["trace"].t1)
    dispatches = ctx["close"]["dispatches"] - ctx["open"]["dispatches"]
    if not recs or dispatches <= 0:
        return None
    return recs, dispatches


def ms_per_dispatch(ctx: dict, *names: str) -> float | None:
    """The summed length of the window's records named ``names``, in
    milliseconds a dispatch."""
    got = window(ctx)
    if got is None:
        return None
    recs, dispatches = got
    return total_ns(recs, *names) / 1e6 / dispatches


def self_ms_per_dispatch(ctx: dict, name: str) -> float | None:
    """The self time of the window's records named ``name`` (less their
    children), in milliseconds a dispatch."""
    got = window(ctx)
    if got is None:
        return None
    recs, dispatches = got
    return self_ns(recs).get(name, 0) / 1e6 / dispatches


def total_ns(recs: Iterable, *names: str) -> int:
    """The summed length of the records named ``names``."""
    return sum(r.end_ns - r.start_ns for r in recs if r.name in names)


def _by_start(recs: Iterable) -> tuple[list, list[int]]:
    """The records by start (an enclosing one before those it holds) and
    the index of each one's innermost enclosing record (-1 for none)."""
    out = sorted(recs, key=lambda r: (r.start_ns, -r.end_ns))
    parent, stack = [], []
    for k, r in enumerate(out):
        while stack and out[stack[-1]].end_ns < r.end_ns:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(k)
    return out, parent


def self_ns(recs: Iterable) -> dict[str, int]:
    """Each name's self time: its records' length less the part their
    child records cover."""
    out, parent = _by_start(recs)
    own: dict[str, int] = {}
    for k, r in enumerate(out):
        d = r.end_ns - r.start_ns
        own[r.name] = own.get(r.name, 0) + d
        if parent[k] >= 0:
            p = out[parent[k]].name
            own[p] = own.get(p, 0) - d
    return own


def name_intervals(recs: Iterable,
                   intervals: Iterable[tuple[int, int]]) -> list[str]:
    """Label each ``(start_ns, end_ns)`` interval with the name of the
    innermost span that covers most of it: each instant goes to the
    innermost record open then, and the name with the most instants wins
    (``"none"`` where no record overlaps the interval)."""
    out, parent = _by_start(recs)
    labels = []
    for s, e in intervals:
        own: dict[int, int] = {}
        for k, r in enumerate(out):
            if r.start_ns >= e:
                break
            overlap = min(r.end_ns, e) - max(r.start_ns, s)
            if overlap > 0:
                own[k] = own.get(k, 0) + overlap
                if parent[k] >= 0:
                    own[parent[k]] = own.get(parent[k], 0) - overlap
        by_name: dict[str, int] = {}
        for k, v in own.items():
            by_name[out[k].name] = by_name.get(out[k].name, 0) + v
        best = max(by_name, key=by_name.get, default=None)
        labels.append(best if best is not None and by_name[best] > 0
                      else "none")
    return labels
