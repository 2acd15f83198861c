"""Slot loop (``serving/stream.py`` ``StreamLoop``): the host's time
moving finished streams' logits over the traced window, in milliseconds a
dispatch: the ``loop.harvest`` spans (a pinned block and its copy queued)
and the ``loop.materialize`` spans (the blocks made rows of the request at
retirement), from the program's span ring (``serving/spans.py``) through
``bench/spanread.py``, over the loop's ``dispatches``.  None where the
program records no spans or the ring dropped some of the window's."""

from bench import spanread


def read(ctx: dict):
    return spanread.ms_per_dispatch(ctx, "loop.harvest", "loop.materialize")
