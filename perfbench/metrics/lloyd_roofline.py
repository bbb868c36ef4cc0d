"""The Lloyd step's share of its roofline, %: the least time the card
needs for the recorded ``lloyd_step`` calls' work (frozen counts at each
call's shape and running restarts, as the kernel skips a stopped one; the
larger of operations over the TF32 peak and bytes over the bandwidth),
over the device time of everything launched inside those calls. The benchmark's wrapper records the calls where
``models/qkmeans.py`` binds ``lloyd_step``."""

from perfbench.work import least_seconds, lloyd_step_work

RANGE = "perfbench.lloyd_step"


def read(ctx):
    calls = ctx.calls.get("lloyd_step")
    if not calls or ctx.trace is None or ctx.peaks is None:
        return None
    device_s = ctx.trace["range_device_s"].get(RANGE, 0.0)
    if device_s <= 0:
        return None
    least, binds = 0.0, set()
    for c in calls:
        t, bound = least_seconds(
            *lloyd_step_work(c["n"], c["m"], c["k"], c["active"],
                             c["x_itemsize"]), ctx.peaks)
        least += t
        binds.add(bound)
    return {"value": 100.0 * least / device_s,
            "note": f"{len(calls)} calls, bound by {'/'.join(sorted(binds))}"}
