"""Slot loop (``serving/stream.py`` ``StreamLoop``): the host's time
staging each step's frames and control word into its pinned buffers over
the traced window, in milliseconds a dispatch: the ``loop.stage`` spans'
self time, less their ``loop.wait_upload`` children (the wait on the card
is ``host_wait_ms_per_dispatch``'s), from the program's span ring
(``serving/spans.py``) through ``bench/spanread.py``, over the loop's
``dispatches``.  None where the program records no spans or the ring
dropped some of the window's."""

from bench import spanread


def read(ctx: dict):
    return spanread.self_ms_per_dispatch(ctx, "loop.stage")
