"""Deployment stochastic processes (paper §2.1) and the fitted Azure priors.

A deployment x is described by latent parameters (lam, mu, sig):
  * core lifetime            ~ Exp(mu)               (rate, per hour)
  * max deployment lifetime  ~ Exp(delta * mu)       (spontaneous shutdown)
  * scale-out events         ~ Poisson(lam * mu**nu) (per hour)
  * scale-out size           ~ 1 + Poisson(sig)
  * initial size C0          ~ 1 + Poisson(sig)      (the arrival request)

Population priors are Gamma(shape, rate) fitted to the Azure trace of
Cortez et al. [2017] (paper Table 1). ``delta`` and ``nu`` are population-wide
constants. Time unit throughout the package: one hour.

PyTorch counterpart of ``repro.core.processes``. Randomness comes from an
explicit ``torch.Generator``; the draws follow the same distributions as the
JAX package but not the same bits. The JAX package's hybrid inversion/PTRS
samplers are a speed device for XLA on the CPU; here ``torch.binomial``,
``torch.poisson`` and ``torch.bernoulli`` draw the same distributions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


class PopulationPriors(NamedTuple):
    """Gamma(shape, rate) hyperparameters for (mu, lam, sig) + global constants."""

    mu_shape: float
    mu_rate: float
    lam_shape: float
    lam_rate: float
    sig_shape: float
    sig_rate: float
    delta: float  # max-lifetime rate multiplier
    nu: float     # scale-out-rate power-law exponent


#: Paper Table 1 — fitted to the Azure internal-jobs trace.
AZURE_PRIORS = PopulationPriors(
    mu_shape=0.3107, mu_rate=0.5778,
    lam_shape=0.4907, lam_rate=0.4496,
    sig_shape=0.2616, sig_rate=0.0552,
    delta=0.119, nu=0.673,
)


class DeploymentParams(NamedTuple):
    """True latent parameters of a batch of deployments. All fields [...]-shaped."""

    lam: torch.Tensor
    mu: torch.Tensor
    sig: torch.Tensor


def scaleout_rate(params: DeploymentParams,
                  priors: PopulationPriors) -> torch.Tensor:
    """Scale-out events per hour: lam * mu**nu (paper §2.1)."""
    return params.lam * params.mu ** priors.nu


def _gamma(gen: torch.Generator, shape_param: float, shape,
           device) -> torch.Tensor:
    """Unit-rate Gamma(shape_param) draws of the given shape, float32."""
    alpha = torch.full(tuple(shape), shape_param, dtype=F32, device=device)
    return torch._standard_gamma(alpha, generator=gen)


def sample_params(gen: torch.Generator, priors: PopulationPriors, shape=(),
                  device=None) -> DeploymentParams:
    """Draw deployment parameters from the population priors (unit-rate
    Gamma draws divided by the rate parameter)."""
    device = gen.device if device is None else device
    lam = _gamma(gen, priors.lam_shape, shape, device) / priors.lam_rate
    mu = _gamma(gen, priors.mu_shape, shape, device) / priors.mu_rate
    sig = _gamma(gen, priors.sig_shape, shape, device) / priors.sig_rate
    return DeploymentParams(lam=lam, mu=mu, sig=sig)


class StepEvents(NamedTuple):
    """Events for one discretized step of length dt hours (per deployment)."""

    core_deaths: torch.Tensor     # cores shut down this step
    spont_death: torch.Tensor     # bool: deployment spontaneously shut down
    n_scaleouts: torch.Tensor     # number of scale-out requests
    scaleout_cores: torch.Tensor  # total cores requested across those scale-outs


def sample_step_events(
    gen,
    params: DeploymentParams,
    cores: torch.Tensor,
    priors: PopulationPriors,
    dt: float,
    alive: torch.Tensor | None = None,
) -> StepEvents:
    """Sample one simulator step of the memoryless processes.

    * each active core dies w.p. 1 - exp(-mu*dt)            (exact thinning)
    * spontaneous death w.p.   1 - exp(-delta*mu*dt)        (memoryless => exact)
    * scale-outs ~ Poisson(lam * mu**nu * dt); total size = k + Poisson(k*sig)
      (a sum of k iid (1 + Poisson(sig)) draws).

    ``alive`` (optional bool mask) zeroes the event *rates* of dead slots
    before sampling; the simulator discards dead slots' events anyway.

    ``gen`` is a ``torch.Generator``, or a sequence of R of them for R runs'
    ``[R, D]`` leaves: run r's events are drawn by ``gen[r]`` from its own
    row, in the order and with the bits of a call on that row alone (four
    draws a run), so a run's draws do not depend on the batch around it.
    """
    if isinstance(gen, torch.Generator):
        rows = lambda fn, *xs: fn(*xs, gen)
    else:
        rows = lambda fn, *xs: torch.stack(
            [fn(*(x[r] for x in xs), g) for r, g in enumerate(gen)])
    alive_f = 1.0 if alive is None else alive.to(F32)
    p_die = -torch.expm1(-params.mu * dt)
    core_deaths = rows(lambda n, p, g: torch.binomial(n, p, generator=g),
                       cores.to(F32) * alive_f, p_die).to(cores.dtype)
    p_spont = -torch.expm1(-priors.delta * params.mu * dt)
    spont_death = rows(lambda p, g: torch.bernoulli(p, generator=g),
                       p_spont).to(torch.bool)
    # on the CPU a power is rounded by the element's place in its tensor
    # (vector body or scalar tail), so a batch takes mu**nu run by run there;
    # the card rounds every element alike
    mu_nu = (params.mu ** priors.nu if params.mu.device.type != "cpu"
             else rows(lambda mu, g: mu ** priors.nu, params.mu))
    poisson = lambda rate, g: torch.poisson(rate, generator=g)
    n_scaleouts = rows(poisson, params.lam * mu_nu * dt * alive_f)
    extra = rows(poisson, n_scaleouts * params.sig)
    scaleout_cores = n_scaleouts + extra
    return StepEvents(core_deaths, spont_death, n_scaleouts, scaleout_cores)


def sample_initial_size(gen: torch.Generator,
                        params: DeploymentParams) -> torch.Tensor:
    """Initial core count C0 ~ 1 + Poisson(sig), float32."""
    return 1.0 + torch.poisson(params.sig, generator=gen)


class PseudoObservations(NamedTuple):
    """k observations of each true scaling process (paper §6 "pseudo
    observations")."""

    n_lifetimes: torch.Tensor       # number of observed core lifetimes (== k)
    sum_lifetimes: torch.Tensor     # total observed lifetime hours
    n_windows: torch.Tensor         # unit-time windows observed for scale-outs (== k)
    n_scaleouts: torch.Tensor       # scale-outs observed in those windows
    n_sizes: torch.Tensor           # scale-out size observations
    sum_size_minus1: torch.Tensor   # sum of (size - 1)


def sample_pseudo_observations(gen: torch.Generator,
                               params: DeploymentParams,
                               priors: PopulationPriors,
                               k: int) -> PseudoObservations:
    """Draw k observations from each true process of each deployment: k
    exponential core lifetimes, k unit-window Poisson scale-out counts and
    k scale-out sizes, reduced to their sums. ``params`` fields are
    [...]-shaped; outputs share that batch shape. k == 0 yields the
    uninformative update.

    The sums are drawn directly, which is equal in law to summing k draws
    and takes O(1) memory a deployment instead of O(k): the lifetimes' sum
    is Gamma(k)/mu, the counts' Poisson(k lam mu**nu), the sizes' minus one
    Poisson(k sig).
    """
    shape = tuple(params.mu.shape)
    device = params.mu.device
    if k == 0:
        z = torch.zeros(shape, dtype=F32, device=device)
        return PseudoObservations(z, z, z, z, z, z)
    kf = torch.full(shape, float(k), dtype=F32, device=device)
    life = torch._standard_gamma(kf, generator=gen) / params.mu
    counts = torch.poisson(k * scaleout_rate(params, priors), generator=gen)
    sizes_m1 = torch.poisson(k * params.sig, generator=gen)
    return PseudoObservations(
        n_lifetimes=kf, sum_lifetimes=life, n_windows=kf,
        n_scaleouts=counts, n_sizes=kf, sum_size_minus1=sizes_m1)
