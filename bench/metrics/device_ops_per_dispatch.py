"""Engine (``CompiledRSNN`` and the loop's step): the kernels, memory
copies and fills that ran on the card in the traced window, from the
profiler's trace, a dispatch of the loop."""


def read(ctx: dict):
    dispatches = ctx["close"]["dispatches"] - ctx["open"]["dispatches"]
    if dispatches <= 0 or not ctx["trace"].ops:
        return None
    return len(ctx["trace"].ops) / dispatches
