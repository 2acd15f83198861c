"""Slot loop (``serving/stream.py`` ``StreamLoop``): the host's time
planning each step over the traced window, in milliseconds a dispatch: the
``loop.plan`` spans (the active slots, each slot's frame count, the fill
mask and the control word), from the program's span ring
(``serving/spans.py``) through ``bench/spanread.py``, over the loop's
``dispatches``.  None where the program records no spans or the ring
dropped some of the window's."""

from bench import spanread


def read(ctx: dict):
    return spanread.ms_per_dispatch(ctx, "loop.plan")
