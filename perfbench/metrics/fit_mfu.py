"""The fits' share of the card's TF32 peak, %: over the window's recorded
``lloyd_step`` calls, the frozen operation count of one Lloyd step at the
call's (n, m, k) and its running restarts (the kernel skips a stopped
one), over the traced window's seconds and the peak. It reads nothing of
how the program implements a step, and leaves out the pre-fit statistics,
the starts and the final evaluations, so it errs low."""

from perfbench.work import lloyd_step_work


def read(ctx):
    calls = ctx.calls.get("lloyd_step")
    if ctx.kind != "fit" or not calls or ctx.trace is None \
            or ctx.peaks is None:
        return None
    ops = sum(lloyd_step_work(c["n"], c["m"], c["k"], c["active"])[1]
              for c in calls)
    return 100.0 * ops / (ctx.trace["window_s"] * ctx.peaks["flops"])
