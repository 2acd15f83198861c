"""Kernels: K6 (``kernels/megastep.py``, ``csrc/megastep.cu``, the frame
step in one launch) against its roofline over the traced window.

K6's device time and launches come from the profiler by kernel name.  Its
least time is the larger of the launches' bytes over the card's bandwidth
and their operations over the peak of the configuration's arithmetic
(``bench/reference/counts.py``); the operations are the reference's
multiply-accumulates a frame at the stored nonzero weights, times the
frames the launches served (the loop's ``frames_served``)."""

from bench.reference import counts

KERNEL = "megastep_kernel"


def read(ctx: dict):
    seconds, launches = ctx["trace"].time_s(KERNEL)
    dispatches = ctx["close"]["dispatches"] - ctx["open"]["dispatches"]
    frames = ctx["close"]["frames_served"] - ctx["open"]["frames_served"]
    if launches == 0 or seconds <= 0 or dispatches <= 0 \
            or ctx["macs_per_frame"] <= 0:
        return None
    cfg, mix = ctx["cfg"], ctx["mix"]
    ops = 2.0 * ctx["macs_per_frame"] * frames / dispatches * launches
    per_launch = counts.launch_bytes(cfg, mix["slots"], mix["chunk_frames"],
                                     ctx["fc_entries"])
    bound = counts.roofline_seconds(cfg, launches, per_launch, ops)
    return 100.0 * bound / seconds
