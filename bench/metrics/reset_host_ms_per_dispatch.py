"""Slot loop (``serving/stream.py`` ``StreamLoop``): the host's time in
slot resets over the traced window, in milliseconds a dispatch: every
``loop.reset`` span, at a refill and at a completion, from the program's
span ring (``serving/spans.py``) through ``bench/spanread.py``, over the
loop's ``dispatches``.  None where the program records no spans or the ring
dropped some of the window's."""

from bench import spanread


def read(ctx: dict):
    return spanread.ms_per_dispatch(ctx, "loop.reset")
