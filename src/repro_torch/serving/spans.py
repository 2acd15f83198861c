"""Spans of the slot loop's host path, kept in memory on the device trace's
clock.

``StreamLoop.step_once`` is the root span ``loop.step`` of one dispatch;
the parts of its host path are its children::

    loop.step              step_once; its record carries the counters
    ├─ loop.refill         _refill -> _on_slot_filled
    │   └─ loop.reset      a filled slot flagged fresh (sid)
    ├─ loop.plan           fill counts, fill mask, the control word
    ├─ loop.stage          the step's host buffers staged
    │   └─ loop.wait_upload    the pinned pair's last upload waited on
    ├─ loop.dispatch       the uploads queued, the graph replayed
    ├─ loop.advance        cursors advanced, completions decided
    │   └─ loop.harvest    each harvest: a pinned block, a D2H queued (sid)
    └─ loop.retire         each retirement of an in-flight step
        ├─ loop.wait_fence     the step's fence waited on
        └─ loop.materialize    each completed stream's logits (sid)

A record is ``Span(name, start_ns, end_ns, dispatch, sid, counts)``:
``dispatch`` is the number of the dispatch whose ``step_once`` made it
(the loop's ``dispatches`` as the root opened), shared by every span of
that call; ``sid`` the request a span acts for (-1 for none);
``counts`` is ``None`` except on the root, which holds the loop's
``(dispatches, frames_served, resets, finishes)`` at its end.  Stamps are
``time.time_ns()``, the clock on which the benchmark matches the
profiler's device events, so an idle gap on the card can be named by
the span the host was in (``bench/spanread.py``).

Recording is on inside ``recording()``, and while a ``torch.profiler``
session runs in the process.  The root tests both once a dispatch and
sets the module flag ``on`` for the length of its call; every other span
reads the flag, so with recording off a span costs two calls that
return at once.  Spans outside a root (a ``flush`` after the last step)
are not recorded.  The records of every loop in the process go into one
ring of ``CAPACITY``; ``window`` returns those inside a window, or
``None`` where the ring has dropped records that may have lain in it.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

CAPACITY = 1 << 18  # records kept; older ones are dropped

STEP = "loop.step"
REFILL = "loop.refill"
RESET = "loop.reset"
PLAN = "loop.plan"
STAGE = "loop.stage"
WAIT_UPLOAD = "loop.wait_upload"
DISPATCH = "loop.dispatch"
ADVANCE = "loop.advance"
HARVEST = "loop.harvest"
RETIRE = "loop.retire"
WAIT_FENCE = "loop.wait_fence"
MATERIALIZE = "loop.materialize"
# each span's possible parents: the tree above
PARENTS = {REFILL: (STEP,), RESET: (REFILL,), PLAN: (STEP,),
           STAGE: (STEP,), WAIT_UPLOAD: (STAGE,), DISPATCH: (STEP,),
           ADVANCE: (STEP,), HARVEST: (ADVANCE,), RETIRE: (STEP,),
           WAIT_FENCE: (RETIRE,), MATERIALIZE: (RETIRE,)}
NAMES = (STEP, *PARENTS)


class Span(NamedTuple):
    """One record of the ring (the module docstring's fields)."""

    name: str
    start_ns: int
    end_ns: int
    dispatch: int
    sid: int
    counts: tuple | None  # the root's (dispatches, frames_served, resets,
    # finishes) at its end


on = False  # recording the step in progress
_forced = 0  # depth of recording() contexts
_dispatch = -1  # the step in progress
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_written = 0  # records ever added, dropped ones included
_profiling = torch.autograd._profiler_enabled


@contextlib.contextmanager
def recording():
    """Record every step inside the context, profiler or not."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def open_step(dispatch: int) -> int:
    """Open the root span of dispatch ``dispatch`` if recording is on;
    returns its start (ns), or 0 when it is off."""
    global on, _dispatch
    on = _forced > 0 or _profiling()
    if not on:
        return 0
    _dispatch = dispatch
    return time.time_ns()


def close_step(start_ns: int, counts: tuple) -> None:
    """Close the root span opened at ``start_ns`` (non-zero) with the
    loop's counters ``counts``."""
    global on, _written
    on = False
    _ring.append((STEP, start_ns, time.time_ns(), _dispatch, -1, counts))
    _written += 1


def now() -> int:
    """A span's start: the time (ns) while recording, else 0."""
    return time.time_ns() if on else 0


def end(name: str, start_ns: int, sid: int = -1) -> None:
    """Record span ``name`` from ``start_ns`` (``now()``'s) to now; nothing
    where ``start_ns`` is 0."""
    global _written
    if start_ns:
        _ring.append((name, start_ns, time.time_ns(), _dispatch, sid, None))
        _written += 1


def records() -> list[Span]:
    """The records in the ring, in the order they ended."""
    return [Span(*r) for r in _ring]


def dropped() -> int:
    """Records the ring has dropped since it was last cleared."""
    return _written - len(_ring)


def clear() -> None:
    """Empty the ring."""
    global _written
    _ring.clear()
    _written = 0


def window(t0_ns: int, t1_ns: int) -> list[Span] | None:
    """The records that lie inside ``[t0_ns, t1_ns]``; ``None`` where the
    ring has dropped records and its oldest kept one ended at or after
    ``t0_ns`` (records are kept in the order they ended, so a dropped one
    may have lain inside the window)."""
    kept = list(_ring)
    if _written > len(kept) and kept and kept[0][2] >= t0_ns:
        return None
    return [Span(*r) for r in kept if r[1] >= t0_ns and r[2] <= t1_ns]
