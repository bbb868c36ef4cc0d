"""The predicts' share of the card's TF32 peak, %: the frozen operation
count of the search at (query rows, train rows, width) for every predict
of the window, over the traced window's seconds and the peak."""

from perfbench.work import argkmin_work


def read(ctx):
    if ctx.kind != "predict" or ctx.trace is None or ctx.peaks is None:
        return None
    ops = sum(argkmin_work(w["nq"], w["nt"], w["m"], w["k"])[1]
              for w in ctx.work)
    return 100.0 * ops / (ctx.trace["window_s"] * ctx.peaks["flops"])
