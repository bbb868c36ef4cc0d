"""95th percentile of every fit's wall time in the window (call to device
synchronize), host clock; numpy's linear percentile."""

import numpy as np


def read(ctx):
    if ctx.kind != "fit" or not ctx.work:
        return None
    return float(np.percentile([w["seconds"] for w in ctx.work], 95))
