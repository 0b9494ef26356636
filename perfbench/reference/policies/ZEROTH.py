"""ZEROTH (the paper's Def. 1, the threshold policy providers use): admit
iff the active cores after admission stay below the threshold. A fleet's
threshold is its total, split over the clusters by capacity."""

CURVES = False   # reads neither the aggregate nor the candidate's curves
SPLIT = True     # a fleet's parameter is split by capacity share


def rule(util, c0, theta, cap, el, vl):
    """(admit [n], margin [n] or None): an exact rule has no margin."""
    return util + c0 < theta, None
