"""The constrained POMDP statement of the cluster admission problem (paper
§2.2), and the tail bounds it reduces to.

  POMDP (S, A, R, T, Omega, O):
    * state s: all active deployments with true (C, lam, mu, sig) + arrivals
      -> in code: ``sim.core.SimState`` (slot arrays of true params)
    * action a: accept/reject each arrival  -> ``policies.admit_sequential``
    * reward R(s) = sum_x C^x               -> ``sim.metrics`` utilization
    * transition T: the processes of ``core.processes``
    * observation O: deployment sizes only (deterministic, many-to-one)
      -> the belief state ``core.belief.GammaBelief`` (conjugate posteriors)
    * constraint: expected scale-out failure fraction <= tau in every safe
      belief state (Problem 1, Eqs. (2)-(4)); in unsafe states the policy
      must reject all arrivals (Eq. (3)) -- the moment policies do so
      because their admission condition already fails, and Def. 4's
      marginal heuristic is the sanctioned carve-out.

Under Assumptions 1-3 the constraint reduces (Prop. 1 / Cor. 1) to

    Pr( sum_x L_n^x > c ) <= tau  for all horizon points n,

which the moment policies bound with Markov / Cantelli; ``failure_bound``
exposes that reduced quantity for analysis and tests. ``core.policies``
keeps its own inline forms of these bounds.

PyTorch counterpart of ``repro.core.pomdp``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SLAConfig(NamedTuple):
    tau: float = 1e-4          # paper §5.2: SLA of 0.01%
    capacity: int = 20_000     # paper §5.2 cluster size


def markov_bound(agg_el: torch.Tensor, capacity) -> torch.Tensor:
    """Markov's inequality (11): Pr(L >= c) <= E[L]/c, per horizon point."""
    return agg_el / capacity


def cantelli_bound(agg_el: torch.Tensor, agg_vl: torch.Tensor,
                   capacity) -> torch.Tensor:
    """Cantelli's inequality (18) at eps = c - E[L] (paper §4.3); 1 when the
    mean already exceeds capacity."""
    slack = capacity - agg_el
    bound = agg_vl / (agg_vl + torch.clamp(slack, min=0.0) ** 2 + 1e-30)
    return torch.where(slack > 0.0, bound, torch.ones_like(bound))


def failure_bound(agg_el: torch.Tensor, agg_vl: torch.Tensor,
                  capacity) -> torch.Tensor:
    """Best available upper bound on Pr(sum L_n > c) per horizon point: the
    smaller of the Markov and Cantelli bounds (both are valid)."""
    return torch.minimum(markov_bound(agg_el, capacity),
                         cantelli_bound(agg_el, agg_vl, capacity))
