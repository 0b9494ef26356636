"""LeastUtilizedRouter: each arrival to the cluster whose active cores are
the least share of its capacity (the first such, in cluster order)."""

import torch


def pick(frac):
    """[k] cluster of each run from its clusters' load fractions [k, C]."""
    return torch.argmin(frac, dim=-1)
