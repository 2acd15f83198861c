"""Slot loop (``serving/stream.py`` ``StreamLoop``): the host's wall time
inside ``step_once`` over the traced window, in milliseconds a dispatch,
from the harness's timer around each call and the loop's ``dispatches``."""


def read(ctx: dict):
    dispatches = ctx["close"]["dispatches"] - ctx["open"]["dispatches"]
    if dispatches <= 0:
        return None
    return 1e3 * (ctx["close"]["step_s"] - ctx["open"]["step_s"]) / dispatches
