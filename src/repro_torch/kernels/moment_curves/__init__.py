"""Moment-curve kernels: per-row curves and the masked cluster aggregate."""
