"""Entry points of the moment-curve kernels.

The kernels read the GammaBelief columns as the slot table holds them and
compute the Gamma-function continuation factors themselves (the belief
form in ``kernel.py``). The D-term's two-point interpolation depends only on
the horizon grid: it is derived once per grid tensor (``curve_grid``) and
kept until the tensor is written to or freed, so an admission core, which
passes the same grid every step, derives it once. The CUDA kernels mask the
ragged edge of D themselves, so nothing is padded.

* ``moment_curves_kernel`` — per-deployment curves [D, N]; drop-in for
  ``core.moments.moment_curves`` (midpoint D-term on ``d_points`` uniform
  checkpoints).
* ``aggregate_moment_curves_kernel`` — cluster-wide masked sums [N]; drop-in
  for ``core.moments.aggregate_moment_curves``. Given the slot tables of R
  runs (columns [R, D]) it returns each run's sums, [R, N], from one launch.

On CUDA tensors they launch the kernels; on CPU tensors the launchers run
the plain PyTorch versions in ``ref.py`` (``pack_belief``, then the packed
forms).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from ...core.belief import GammaBelief
from ...core.moments import MomentCurves, interp_points
from ...core.processes import F32, PopulationPriors
from .kernel import moment_curves_agg_belief, moment_curves_belief


class CurveGrid(NamedTuple):
    """The horizon grid and the D-term's interpolation, as the kernels take
    them."""

    t: torch.Tensor       # [N] float32 horizon times
    idx: torch.Tensor     # [N] int32 left checkpoint
    frac: torch.Tensor    # [N] float32 weight of the right one
    nd: int               # D-term checkpoints


def curve_grid(t_grid: torch.Tensor, d_points: int) -> CurveGrid:
    t = t_grid.to(F32).contiguous()
    _, idx, frac = interp_points(t, d_points)
    return CurveGrid(t, idx, frac.contiguous(), d_points)


# (id of a horizon grid, d_points) -> (weak reference to it, its version,
# its CurveGrid)
_GRIDS: dict = {}
_GRIDS_KEPT = 64


def _grid_of(t_grid: torch.Tensor, d_points: int) -> CurveGrid:
    """``curve_grid(t_grid, d_points)``, derived again only when ``t_grid``
    is another tensor or was written to in place (every time for an
    inference tensor, which has no version counter)."""
    if t_grid.is_inference():
        return curve_grid(t_grid, d_points)
    key = (id(t_grid), d_points)
    hit = _GRIDS.get(key)
    if (hit is not None and hit[0]() is t_grid
            and hit[1] == t_grid._version):
        return hit[2]
    if len(_GRIDS) >= _GRIDS_KEPT:
        _GRIDS.clear()
    grid = curve_grid(t_grid, d_points)
    _GRIDS[key] = (weakref.ref(t_grid), t_grid._version, grid)
    return grid


def moment_curves_kernel(bel: GammaBelief, cores: torch.Tensor,
                         t_grid: torch.Tensor, priors: PopulationPriors, *,
                         d_points: int = 32) -> MomentCurves:
    """Kernel-backed moment curves. bel fields/cores: [D]; t_grid: [N]."""
    el, vl = moment_curves_belief(bel, cores, *_grid_of(t_grid, d_points),
                                  priors)
    return MomentCurves(EL=el, VL=vl)


def aggregate_moment_curves_kernel(
        bel: GammaBelief, cores: torch.Tensor, alive: torch.Tensor,
        t_grid: torch.Tensor, priors: PopulationPriors, *,
        d_points: int = 32) -> MomentCurves:
    """Aggregate (sum over alive slots) curves via the aggregate kernel:
    [N] for bel fields/cores/alive [D], [R, N] for R runs' [R, D]."""
    el, vl = moment_curves_agg_belief(bel, cores, alive,
                                      *_grid_of(t_grid, d_points), priors)
    return MomentCurves(EL=el, VL=vl)
