"""Slot loop (``serving/stream.py`` ``StreamLoop``): the time the host
blocked on the card over the traced window, in milliseconds a dispatch:
the ``loop.wait_fence`` spans (an in-flight step's fence, at retirement)
and the ``loop.wait_upload`` spans (a pinned pair's last upload, at
staging), from the program's span ring (``serving/spans.py``) through
``bench/spanread.py``, over the loop's ``dispatches``.  None where the
program records no spans or the ring dropped some of the window's."""

from bench import spanread


def read(ctx: dict):
    return spanread.ms_per_dispatch(ctx, "loop.wait_fence",
                                    "loop.wait_upload")
