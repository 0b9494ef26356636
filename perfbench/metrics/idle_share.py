"""idle_share: the share of the traced stretch's wall time in which nothing
ran on the card (one less the union of the device's intervals over the
wall)."""
from perfbench.trace import busy_us


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 1.0 - busy_us(tr) / 1e6 / tr.window_s
