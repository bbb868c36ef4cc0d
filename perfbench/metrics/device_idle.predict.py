"""The share of the traced window of the predicts in which no kernel, copy
or set ran on the device, % (the profiler's device trace)."""


def read(ctx):
    if ctx.kind != "predict" or ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
