"""Entry points of the moment-curve kernels.

Packs the GammaBelief into the kernels' [D, 16] parameter rows via
``core.moments.pack_belief`` (the Gamma-function continuation factors, which
need lgamma, are computed here once per row), derives the D-term's two-point
interpolation from the horizon grid, and unpacks MomentCurves. The CUDA
kernels mask the ragged edge of D themselves, so nothing is padded.

* ``moment_curves_kernel`` — per-deployment curves [D, N]; drop-in for
  ``core.moments.moment_curves`` (midpoint D-term on ``d_points`` uniform
  checkpoints).
* ``aggregate_moment_curves_kernel`` — cluster-wide masked sums [N]; drop-in
  for ``core.moments.aggregate_moment_curves``.

On CUDA tensors both launch the kernels; on CPU tensors the launchers run
the plain PyTorch versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from ...core.belief import GammaBelief
from ...core.moments import MomentCurves, interp_points, pack_belief
from ...core.processes import F32, PopulationPriors
from .kernel import moment_curves_agg_packed, moment_curves_packed


def _pack(bel: GammaBelief, cores: torch.Tensor, priors: PopulationPriors,
          alive: torch.Tensor | None = None) -> torch.Tensor:
    """[D, 16] packed parameter rows, ALIVE in column 14 (ones if absent)."""
    p = pack_belief(bel, cores, priors)
    a = p.a
    delta = torch.full_like(a, priors.delta)
    mask = torch.ones_like(a) if alive is None else alive.to(F32)
    cols = [p.a, p.b, p.cores, p.eu, p.eu2, p.el, p.es1, p.ess2, p.rh1, p.z1,
            p.rk, p.z2, p.e_mu_nu, delta, mask, torch.zeros_like(a)]
    return torch.stack(cols, dim=-1).to(F32).contiguous()


def _grids(t_grid: torch.Tensor, d_points: int):
    """(t [N] f32, idx [N] int32, frac [N] f32) for the launchers."""
    t = t_grid.to(F32).contiguous()
    _, idx, frac = interp_points(t, d_points)
    return t, idx, frac.contiguous()


def moment_curves_kernel(bel: GammaBelief, cores: torch.Tensor,
                         t_grid: torch.Tensor, priors: PopulationPriors, *,
                         d_points: int = 32) -> MomentCurves:
    """Kernel-backed moment curves. bel fields/cores: [D]; t_grid: [N]."""
    el, vl = moment_curves_packed(_pack(bel, cores, priors),
                                  *_grids(t_grid, d_points), d_points)
    return MomentCurves(EL=el, VL=vl)


def aggregate_moment_curves_kernel(
        bel: GammaBelief, cores: torch.Tensor, alive: torch.Tensor,
        t_grid: torch.Tensor, priors: PopulationPriors, *,
        d_points: int = 32) -> MomentCurves:
    """Aggregate (sum over alive slots) curves [N] via the aggregate kernel."""
    el, vl = moment_curves_agg_packed(_pack(bel, cores, priors, alive=alive),
                                      *_grids(t_grid, d_points), d_points)
    return MomentCurves(EL=el, VL=vl)
