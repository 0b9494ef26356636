"""Conjugate Gamma belief state over deployment scaling processes (paper §2.2).

The provider cannot observe (lam, mu, sig); it maintains, per deployment slot,
Gamma posteriors that start at the population prior and are updated from the
observable events (core deaths + exposure, scale-out counts, scale-out sizes):

  * mu  | data ~ Gamma(a  + #deaths,      b  + total core-hours observed)
  * sig | data ~ Gamma(as + sum(size-1),  bs + #size observations)
  * lam | data ~ Gamma(al + #scale-outs,  bl + E[mu**nu] * alive-hours)
        (mu is latent, so the exposure uses the posterior mean of mu**nu —
        an E-step approximation that keeps the update conjugate and O(1).)

PyTorch counterpart of ``repro.core.belief``; all fields are float32 tensors
over deployment slots.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .processes import F32, PopulationPriors


def _log_mu_pow(mu_a: torch.Tensor, mu_b: torch.Tensor, p: float):
    """log E[mu**p] = lgamma(a+p) - lgamma(a) - p log b under Gamma(a, b)."""
    return torch.lgamma(mu_a + p) - torch.lgamma(mu_a) - p * torch.log(mu_b)


class GammaBelief(NamedTuple):
    """Per-slot Gamma(shape, rate) posteriors for (mu, lam, sig)."""

    mu_a: torch.Tensor
    mu_b: torch.Tensor
    lam_a: torch.Tensor
    lam_b: torch.Tensor
    sig_a: torch.Tensor
    sig_b: torch.Tensor

    def expected_mu_pow(self, p) -> torch.Tensor:
        """E[mu**p] = Gamma(a+p)/Gamma(a) / b**p under mu ~ Gamma(a, b)."""
        return torch.exp(_log_mu_pow(self.mu_a, self.mu_b, p))


def belief_from_prior(priors: PopulationPriors, shape=(),
                      device=None) -> GammaBelief:
    """Fresh belief equal to the population prior for every slot."""
    full = lambda v: torch.full(tuple(shape), v, dtype=F32, device=device)
    return GammaBelief(
        mu_a=full(priors.mu_shape), mu_b=full(priors.mu_rate),
        lam_a=full(priors.lam_shape), lam_b=full(priors.lam_rate),
        sig_a=full(priors.sig_shape), sig_b=full(priors.sig_rate),
    )


def update_on_events(
    bel: GammaBelief,
    *,
    core_deaths: torch.Tensor,
    exposure_core_hours: torch.Tensor,
    n_scaleouts: torch.Tensor,
    scaleout_cores: torch.Tensor,
    alive_hours: torch.Tensor,
    priors: PopulationPriors,
) -> GammaBelief:
    """One observation step. All args are per-slot tensors (zeros for no-ops).

    ``exposure_core_hours`` is the total core-hours lived this step (dead and
    surviving cores alike); ``scaleout_cores`` is the total cores requested,
    so sizes-minus-one sum to ``scaleout_cores - n_scaleouts``.
    """
    mu_a = bel.mu_a + core_deaths
    mu_b = bel.mu_b + exposure_core_hours
    # E-step exposure for lam uses the *updated* mu posterior.
    e_mu_nu = torch.exp(_log_mu_pow(mu_a, mu_b, priors.nu))
    lam_a = bel.lam_a + n_scaleouts
    lam_b = bel.lam_b + e_mu_nu * alive_hours
    sig_a = bel.sig_a + (scaleout_cores - n_scaleouts)
    sig_b = bel.sig_b + n_scaleouts
    return GammaBelief(mu_a, mu_b, lam_a, lam_b, sig_a, sig_b)


def observe_initial_size(bel: GammaBelief, c0: torch.Tensor) -> GammaBelief:
    """The arrival request C0 ~ 1 + Poisson(sig) is itself a size observation."""
    return bel._replace(sig_a=bel.sig_a + (c0 - 1), sig_b=bel.sig_b + 1.0)
