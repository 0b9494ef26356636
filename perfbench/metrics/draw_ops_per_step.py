"""draw_ops_per_step: the event samplers' host operators (aten::binomial,
aten::bernoulli, aten::poisson) the traced stretch called, over its batched
steps."""

DRAWS = ("aten::binomial", "aten::bernoulli", "aten::poisson")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    n = sum(1 for name, _, _ in tr.host_ops if name in DRAWS)
    return n / tr.steps if n else None
