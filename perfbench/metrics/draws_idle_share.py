"""draws_idle_share: the card's idle time in the traced stretch put down
to the port's ``repro.sim.draws`` ranges, over the stretch's wall time.
Each gap between device intervals goes whole to the innermost range open
on the host over most of it (``perfbench/ranges.py`` ``idle_by_span``);
the shares of every range and of the time outside them add up to
``idle_share``. Nothing to read without the card's kernels or without the
range."""
from perfbench import ranges

DRAWS = "repro.sim.draws"


def read(ctx):
    rg = ranges.of(ctx.trace)
    if rg is None or not ranges.calls(rg, DRAWS):
        return None
    return ranges.idle_by_span(rg).get(DRAWS, 0.0) / rg.window_us
