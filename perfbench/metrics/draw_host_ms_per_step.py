"""draw_host_ms_per_step: host milliseconds inside the event samplers'
operators (aten::binomial, aten::bernoulli, aten::poisson) over the traced
stretch's batched steps."""

DRAWS = ("aten::binomial", "aten::bernoulli", "aten::poisson")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    us = [d for name, _, d in tr.host_ops if name in DRAWS]
    return sum(us) / 1e3 / tr.steps if us else None
