"""kernels_per_step: CUDA kernels the traced stretch launched, over its
batched steps."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / tr.steps
