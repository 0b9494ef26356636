"""driver_ms_per_step: host milliseconds inside the port's
``repro.sim.batch`` range (``run_keyed_batch``) and outside its
``repro.sim.step`` ranges (the stream's move and per-step views, the
fresh state, the metrics and their stacking, the batch's own Python),
over the traced stretch's batched steps. Read from the profile that holds
the card's kernels (``perfbench/ranges.py``): nothing to read without
them or without the range."""
from perfbench import ranges


def read(ctx):
    rg = ranges.of(ctx.trace)
    if rg is None or not ranges.calls(rg, ranges.BATCH):
        return None
    return (ranges.host_ms(rg, ranges.BATCH)
            - ranges.host_ms(rg, ranges.STEP)) / rg.steps
