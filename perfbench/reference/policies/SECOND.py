"""SECOND (the paper's Def. 3, Cantelli): admit iff at every grid point the
aggregate E[L] after admission is at most the capacity and its Cantelli
mass V / (V + (c - E)^2) at most rho."""

import torch

CURVES = True    # reads the aggregate and the candidate's curves
SPLIT = False    # rho is the same in every cluster of a fleet


def rule(util, c0, theta, cap, el, vl):
    """(admit [n], margin [n]): the widest relative amount by which a
    point's E[L] passes the capacity or its mass passes rho; admit iff it
    is at most 0. ``el``, ``vl``: [n, N] curves after admission."""
    slack = torch.clamp(cap[:, None] - el, min=0.0)
    cant = vl / (vl + slack ** 2 + 1e-30)
    v = torch.maximum(
        torch.amax((el - cap[:, None]) / cap[:, None], dim=-1),
        torch.amax((cant - theta[:, None]) / theta[:, None], dim=-1))
    return v <= 0.0, v
