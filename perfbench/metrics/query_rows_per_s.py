"""Query rows labelled per second: every row of every predict the window
completed, over the whole window's time, host clock."""


def read(ctx):
    if ctx.kind != "predict" or not ctx.work:
        return None
    return sum(w["nq"] for w in ctx.work) / ctx.window_s
