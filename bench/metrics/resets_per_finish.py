"""Slot loop (``serving/stream.py`` ``StreamLoop``): slot resets a
finished stream over the traced window: the change of the loop's
``resets`` over that of its ``finishes`` between the first and the last
``loop.step`` span in the window, each of which holds the counters at its
end (``serving/spans.py``, read through ``bench/spanread.py``).  None
where the program records no spans, the ring dropped some of the
window's, or no stream finished between them."""

from bench import spanread


def read(ctx: dict):
    got = spanread.window(ctx)
    if got is None:
        return None
    roots = sorted((r for r in got[0] if r.name == "loop.step"),
                   key=lambda r: r.end_ns)
    if len(roots) < 2:
        return None
    first, last = roots[0].counts, roots[-1].counts
    finishes = last[3] - first[3]
    if finishes <= 0:
        return None
    return (last[2] - first[2]) / finishes
