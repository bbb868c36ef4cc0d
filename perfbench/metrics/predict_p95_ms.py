"""95th percentile of every predict's wall time in the window (call to
device synchronize), milliseconds, host clock; numpy's linear
percentile."""

import numpy as np


def read(ctx):
    if ctx.kind != "predict" or not ctx.latencies:
        return None
    return 1e3 * float(np.percentile(ctx.latencies, 95))
