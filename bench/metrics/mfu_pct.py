"""Model step: the frames served a second in the traced window (the loop's
``frames_served`` over the window) times the dense model's operations a
frame at its published shapes and stored FC density (2 per
multiply-accumulate), as a share of the peak of the configuration's
arithmetic (``bench/reference/counts.py``).  It bounds every kernel's
share from above, whichever kernel computes the frame."""

from bench.reference import counts
from bench.reference.model import dense_macs_per_frame


def read(ctx: dict):
    frames = ctx["close"]["frames_served"] - ctx["open"]["frames_served"]
    window = ctx["trace"].window_s
    if frames <= 0 or window <= 0:
        return None
    cfg = ctx["cfg"]
    ops_per_s = 2.0 * dense_macs_per_frame(cfg) * frames / window
    return 100.0 * ops_per_s / counts.PEAK_OPS_PER_S[cfg["precision"]]
