"""setup_s: process start to the first timed batch (host clock): imports,
the CUDA context, the kernels' build or load, building the run, the warm-up
batch."""


def read(ctx):
    return ctx.setup_s
