"""Lloyd steps per fit: the window's recorded ``lloyd_step`` calls (one a
step of the q-means loop, every running restart in it) over the fits the
window completed. The loop runs until its last restart stops, so this
reads the loop's work, where a fit's ``n_iter_`` reads its winner's."""


def read(ctx):
    calls = ctx.calls.get("lloyd_step")
    if ctx.kind != "fit" or not calls or not ctx.work:
        return None
    return len(calls) / len(ctx.work)
