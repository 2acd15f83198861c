"""Device (H100): the share of the traced window in which no kernel, no
memory copy and no memory fill ran on the card, from the profiler's
trace."""


def read(ctx: dict):
    window = ctx["trace"].window_s
    if window <= 0 or not ctx["trace"].ops:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s() / window)
