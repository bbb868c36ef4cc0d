"""The share of the traced window of the fits in which no kernel, copy or
set ran on the device, % (the profiler's device trace)."""


def read(ctx):
    if ctx.kind != "fit" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
