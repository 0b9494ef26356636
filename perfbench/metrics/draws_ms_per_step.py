"""draws_ms_per_step: host milliseconds inside the port's
``repro.sim.draws`` ranges (a step's event draws: ``sample_step_events``'s
loop over the runs, its samplers, stacks, casts and rate arithmetic) over
the traced stretch's batched steps. Read from the profile that holds the
card's kernels (``perfbench/ranges.py``): nothing to read without them or
without the range."""
from perfbench import ranges


def read(ctx):
    rg = ranges.of(ctx.trace)
    if rg is None or not ranges.calls(rg, "repro.sim.draws"):
        return None
    return ranges.host_ms(rg, "repro.sim.draws") / rg.steps
