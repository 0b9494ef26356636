"""refresh_device_ms: device milliseconds of the kernels launched inside
the port's ``repro.sim.refresh`` ranges (the aggregate refresh, whatever
kernel does it), over the ranges' count. A kernel's launch is its runtime
call on the host, found by the kernel's correlation id
(``perfbench/ranges.py``). Nothing to read without the card's kernels or
without the range."""
from perfbench import ranges

REFRESH = "repro.sim.refresh"


def read(ctx):
    rg = ranges.of(ctx.trace)
    n = 0 if rg is None else ranges.calls(rg, REFRESH)
    return ranges.device_ms_in(rg, REFRESH) / n if n else None
