"""Slot loop: device-to-host transfers the loop makes (its ``host_syncs``
counter: logit harvests and counter fetches) a thousand frames served
(its ``frames_served`` counter), over the traced window."""


def read(ctx: dict):
    frames = ctx["close"]["frames_served"] - ctx["open"]["frames_served"]
    if frames <= 0:
        return None
    syncs = ctx["close"]["host_syncs"] - ctx["open"]["host_syncs"]
    return 1e3 * syncs / frames
