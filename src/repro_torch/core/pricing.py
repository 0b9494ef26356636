"""Variance-based pricing and information elicitation (paper §7).

The payment rule q(x) = kappa1 * C^x + kappa2 * Var(x) makes labeling
deployment types a dominant strategy (Prop. 4 / Cor. 2, via the law of total
variance): a mixture of two types always has at least the mixture-weighted
variance of its components, so a user minimizes the variance charge by
splitting the mixture into labeled categories.

``mixture_moments`` is the provider's belief over an *unlabeled* arrival (a
type mixture): the exact law-of-total-variance computation the proposition
rests on, used by the simulator's unlabeled mode and the Fig. 2 driver.

PyTorch counterpart of ``repro.core.pricing``.
"""
from __future__ import annotations

import torch

from .moments import MomentCurves


def payment(c0: torch.Tensor, var_estimate: torch.Tensor,
            kappa1: float = 1.0, kappa2: float = 0.01) -> torch.Tensor:
    """Hourly variance-based payment rule, Eq. (30)."""
    return kappa1 * c0 + kappa2 * var_estimate


def variance_estimate(curves: MomentCurves) -> torch.Tensor:
    """The provider's scalar Var(x) estimate for pricing: the peak of the
    posterior-predictive variance curve over the horizon."""
    return torch.amax(curves.VL, dim=-1)


def mixture_moments(weights, curves: MomentCurves) -> MomentCurves:
    """Moments of a mixture over K type components (law of total variance).

    weights: [K]; curves.EL/VL: [K, ..., N]. Returns the mixture's curves:
      E = sum_k w_k E_k
      V = sum_k w_k (V_k + E_k^2) - E^2   (= E[V|type] + V[E|type])
    """
    w = torch.as_tensor(weights, dtype=curves.EL.dtype,
                        device=curves.EL.device)
    w = w.reshape((-1,) + (1,) * (curves.EL.ndim - 1))
    e = torch.sum(w * curves.EL, dim=0)
    second = torch.sum(w * (curves.VL + curves.EL**2), dim=0)
    return MomentCurves(EL=e, VL=torch.clamp(second - e**2, min=0.0))


def mixture_variance_excess(weights: torch.Tensor,
                            e_components: torch.Tensor,
                            v_components: torch.Tensor) -> torch.Tensor:
    """Var(mixture) - sum_k w_k Var(component_k) = Var_k(E[.|k]) >= 0: the
    quantity Prop. 4 shows is nonnegative (the user's saving from
    labeling)."""
    e_mix = torch.sum(weights * e_components, dim=0)
    return torch.sum(weights * (e_components - e_mix) ** 2, dim=0)
