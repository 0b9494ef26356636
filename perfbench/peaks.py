"""The card's peaks and the moment-curve aggregate's operations and bytes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W limit): HBM 3.35 TB/s, FP32 outside the tensor cores 67 TFLOP/s.

The aggregate refresh sums, for each slot table, the moment curves of its
slots over an N-point horizon grid with an ND-checkpoint D-term, each
slot's curves masked by whether it is alive. Operations a row: per grid
point, per D-term checkpoint and for the row's pack of its belief, one per
arithmetic instruction or math-library call (log1pf, expm1f, expf, logf,
lgammaf, division), as counted from the kernel source of the port's
aggregate (``moment_curves.cu``) when it was written. Every one of the
D rows of a table is counted, alive or not, as the masked sum reads them.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

OPS_PER_POINT = 75
OPS_PER_CHECKPOINT = 35
OPS_PER_PACK = 46
BELIEF_COLUMNS = 7          # six Gamma parameters and the cores, float32


def aggregate_work(tables: int, rows: int, n: int, nd: int) -> tuple:
    """(operations, bytes) of one refresh over ``tables`` tables of ``rows``
    slots: each slot's alive flag and columns read once, the grid (times,
    left checkpoints, weights) read once, each table's 2 N sums written
    once."""
    d = tables * rows
    ops = d * (n * OPS_PER_POINT + nd * OPS_PER_CHECKPOINT + OPS_PER_PACK)
    nbytes = d * (1 + 4 * BELIEF_COLUMNS) + 4 * 3 * n + tables * 4 * 2 * n
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S)
