"""cluster_steps_per_s: runs x clusters x steps the window's batches
completed, over the window's wall time from the first batch's start to the
last batch's end (host clock; every batch ends with a wait for the card)."""


def read(ctx):
    if not ctx.spans:
        return None
    return len(ctx.spans) * ctx.work / (ctx.spans[-1][1] - ctx.spans[0][0])
