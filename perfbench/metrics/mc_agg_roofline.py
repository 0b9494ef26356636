"""mc_agg_roofline: the aggregate refresh kernel's share of its roofline, %.

Over the traced stretch: the least time the card could take for its
refreshes (one at every ``agg_refresh_steps``-th step from the first, each
over every table's D slots: ``perfbench.peaks``, the operations at FP32
peak against the bytes at HBM bandwidth), over the device time of the
aggregate kernel (``mc_agg_belief``'s ``agg_kernel``) in the trace. Nothing
to read where the trace has no such kernel.
"""
from perfbench.peaks import aggregate_work, least_seconds

KERNEL = "agg_kernel"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    dev_us = sum(d for name, _, d in tr.kernels if KERNEL in name)
    if dev_us <= 0.0:
        return None
    cfg = ctx.config
    k = int(cfg["agg_refresh_steps"])
    refreshes = -(-tr.steps // k)
    ops, nbytes = aggregate_work(ctx.traffic.runs * ctx.traffic.clusters,
                                 int(cfg["max_slots"]),
                                 len(cfg["grid"]["points"]),
                                 int(cfg["d_points"]))
    return 100.0 * refreshes * least_seconds(ops, nbytes) / (dev_us / 1e6)
