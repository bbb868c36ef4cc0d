"""The k-nearest search's share of its roofline, %: the least time the
card needs for the recorded ``argkmin`` calls' work (frozen counts; the
larger of operations over the TF32 peak and bytes over the bandwidth),
over the device time of everything launched inside those calls. The
benchmark's wrapper records the calls where ``models/neighbors.py`` binds
``argkmin``."""

from perfbench.work import argkmin_work, least_seconds

RANGE = "perfbench.argkmin"


def read(ctx):
    calls = ctx.calls.get("argkmin")
    if not calls or ctx.trace is None or ctx.peaks is None:
        return None
    device_s = ctx.trace["range_device_s"].get(RANGE, 0.0)
    if device_s <= 0:
        return None
    least, binds = 0.0, set()
    for c in calls:
        t, bound = least_seconds(*argkmin_work(c["nq"], c["nt"], c["m"],
                                               c["k"]), ctx.peaks)
        least += t
        binds.add(bound)
    return {"value": 100.0 * least / device_s,
            "note": f"{len(calls)} calls, bound by {'/'.join(sorted(binds))}"}
