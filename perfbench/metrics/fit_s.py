"""Seconds per fit: the whole window's time over the fits it completed
(each fit timed from its call to a device synchronize after it returns),
host clock."""


def read(ctx):
    if ctx.kind != "fit" or not ctx.work:
        return None
    return ctx.window_s / len(ctx.work)
