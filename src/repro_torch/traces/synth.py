"""Vectorized trace generators + the scenario registry.

``synthesize_trace`` draws an Azure-like workload trace from
``PopulationPriors`` in one vectorized pass (no Python loop over
deployments), following the paper's §2.1 generative model:

  * arrivals: an inhomogeneous Poisson process via time-warping — the count
    comes from the integrated rate, and sorted uniforms on [0, Λ(horizon)]
    map through the inverse cumulative rate (a dense interpolation table),
    which is exact up to interpolation and, unlike thinning at the peak
    rate, wastes no trace capacity on bursty profiles;
  * latents (lam, mu, sig) ~ the Gamma priors; C0 ~ 1 + Poisson(sig);
  * observation window = min(Exp(delta * mu), horizon - arrival) (exact,
    memoryless), with the spontaneous-death indicator recorded;
  * scale-outs ~ Poisson(lam * mu**nu * window); the first ``max_events``
    events land in the trace's event buffer (times iid uniform over the
    window — exact for a Poisson process conditioned on its count), sizes
    1 + Poisson(sig); the scalar totals include the tail beyond the buffer;
  * core-death observables: initial cores use exact binomial thinning over
    the full window; scale-out cores are thinned with the *marginal* death
    probability under a per-core independent U(0, window) remaining window,
    paired with the Rao-Blackwellized expected exposure
    E[min(lifetime, window)] for ``core_hours``, so the censored
    exponential MLE mu_hat = deaths / core_hours stays consistent at the
    mean level while the generator never materializes a per-core array.

Scenario modifiers compose on top: ``rate_profile`` (arrival-rate
modulation), ``heavy_frac``/``heavy_mu_scale`` (heavy-tail lifetime
inflation via a mu-mixture), ``batch_size``/``batch_share_params``
(correlated batch arrivals that share an arrival instant and, optionally,
latent parameters), and ``param_drift`` (non-stationary priors: per-arrival
multiplicative factors on the sampled latents as a function of arrival
time). Named combinations are registered in ``_SCENARIOS``:
``register_scenario`` / ``get_scenario`` / ``scenario_names`` /
``synthesize_scenario``.

PyTorch counterpart of ``repro.traces.synth``. Every draw comes from one
``torch.Generator``, in a fixed order, on the generator's device; the draws
follow the JAX package's distributions but not its bits (``torch.poisson``
and ``torch.binomial`` where it uses its own samplers).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.processes import (AZURE_PRIORS, F32, DeploymentParams,
                              PopulationPriors, sample_params, scaleout_rate)
from ..device import resolve_device
from ..obs.log import get_logger
from .schema import ScaleoutEvents, WorkloadTrace

log = get_logger(__name__)


class TraceSpec(NamedTuple):
    """Static shape/rate parameters of a synthetic trace."""

    horizon_hours: float = 365 * 24.0
    arrival_rate: float = 0.25       # deployments/hour (base, pre-modulation)
    max_deployments: int = 4096      # trace capacity D (Poisson tail clipped)
    max_events: int = 16             # event-buffer width E per deployment
    priors: PopulationPriors = AZURE_PRIORS


def _expected_exposure_frac(mu: torch.Tensor, w: torch.Tensor,
                            uniform_window: bool
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P(death), E[min(lifetime, W)]) for Exp(mu) lifetimes.

    ``uniform_window=False``: fixed window W = w. ``True``: W ~ U(0, w) —
    the remaining window of a core added at a uniform event time. Both are
    exact; the small-mu*w branch avoids 0/0 in float32.
    """
    mw = mu * w
    ems = -torch.expm1(-mw)                       # 1 - exp(-mu w)
    if not uniform_window:
        p_die = ems
        exposure = torch.where(mw > 1e-6, ems / torch.clamp(mu, min=1e-30), w)
        return p_die, exposure
    # W ~ U(0, w): P(T < W) = 1 - (1 - e^{-mu w})/(mu w); E[min(T,W)] = P/mu
    p_die = torch.where(mw > 1e-6,
                        1.0 - ems / torch.clamp(mw, min=1e-30), mw / 2.0)
    exposure = torch.where(mw > 1e-6, p_die / torch.clamp(mu, min=1e-30),
                           w / 2.0)
    return p_die, exposure


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """Piecewise-linear interpolation of (xp, fp) at x, clamped to fp's end
    values outside [xp[0], xp[-1]]: the arithmetic of ``jnp.interp``
    (bracket by ``searchsorted``, then fp[i-1] + (x - xp[i-1]) / dx * df)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = torch.finfo(xp.dtype).eps
    dx0 = torch.abs(dx) <= eps * eps         # np.spacing(eps) in float32
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


_WARP_POINTS = 4096  # inverse-cumulative-rate interpolation table density


def warp_table(rate_profile, horizon: float, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cumulative rate mass, time) at ``_WARP_POINTS + 1`` points of the
    horizon: the trapezoid integral of ``rate_profile`` (clipped at zero),
    whose inverse maps uniform masses to arrival times."""
    t_grid = torch.linspace(0.0, horizon, _WARP_POINTS + 1, dtype=F32,
                            device=device)
    r_grid = torch.clamp(rate_profile(t_grid), min=0.0)
    dt_g = horizon / _WARP_POINTS
    lam_grid = torch.cat([
        torch.zeros(1, dtype=F32, device=device),
        torch.cumsum(0.5 * (r_grid[1:] + r_grid[:-1]) * dt_g, dim=0)])
    return lam_grid, t_grid


def synthesize_trace(
    gen: torch.Generator,
    spec: TraceSpec,
    *,
    rate_profile: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    heavy_frac: float = 0.0,
    heavy_mu_scale: float = 1.0,
    batch_size: int = 1,
    batch_share_params: bool = False,
    param_drift: Optional[Callable[[torch.Tensor], DeploymentParams]] = None,
) -> WorkloadTrace:
    """One synthetic ``WorkloadTrace`` from the population priors, drawn
    from ``gen`` on its device.

    ``rate_profile(t_hours)`` returns the relative (nonnegative) arrival-rate
    multiplier at time t; arrivals form the inhomogeneous Poisson process
    with intensity ``arrival_rate * rate_profile(t)`` via exact time-warping.
    ``heavy_frac`` of deployments get ``mu *= heavy_mu_scale`` (lifetime
    inflation for ``heavy_mu_scale < 1``). ``batch_size > 1`` snaps blocks of
    consecutive arrivals to their leader's arrival instant (correlated
    batches), sharing the leader's latent parameters when
    ``batch_share_params``. ``param_drift(t_arr)`` returns per-deployment
    multiplicative factors (a ``DeploymentParams`` of multipliers) applied
    to the sampled latents as a function of arrival time.
    """
    device = gen.device
    priors = spec.priors
    d, e = spec.max_deployments, spec.max_events
    horizon = spec.horizon_hours
    poisson = lambda rate: torch.poisson(rate, generator=gen)
    uniform = lambda *shape: torch.rand(shape, generator=gen, dtype=F32,
                                        device=device)
    arange_d = torch.arange(d, device=device)

    # -- arrival stream (inhomogeneous Poisson via time-warping) ------------
    if rate_profile is None:
        total_mass = torch.tensor(horizon, dtype=F32, device=device)
        warp = None
    else:
        lam_grid, t_grid = warp_table(rate_profile, horizon, device)
        total_mass = lam_grid[-1]
        warp = lambda m: interp(m, lam_grid, t_grid)
    n = torch.clamp(poisson((spec.arrival_rate * total_mass).reshape(1)),
                    max=d).to(torch.int32)
    valid = arange_d < n
    # event "masses" of a Poisson process given its count are n iid uniforms
    # on [0, Λ(horizon)]: the unused tail is masked *before* sorting (2*mass
    # sorts after every real arrival), so the valid prefix is exactly n
    # sorted uniforms
    u = torch.where(valid, uniform(d) * total_mass, 2.0 * total_mass)
    masses = torch.sort(u).values
    t_arr = masses if warp is None else torch.where(
        valid, warp(masses), 2.0 * horizon)

    # -- latent parameters + modifiers --------------------------------------
    params = sample_params(gen, priors, (d,))
    if heavy_frac > 0.0:
        is_heavy = torch.bernoulli(torch.full((d,), heavy_frac, dtype=F32,
                                              device=device), generator=gen)
        params = params._replace(mu=torch.where(
            is_heavy > 0, params.mu * heavy_mu_scale, params.mu))
    if batch_size > 1:
        leader = torch.div(arange_d, batch_size,
                           rounding_mode="floor") * batch_size
        t_arr = t_arr[leader]
        if batch_share_params:
            params = DeploymentParams(*(x[leader] for x in params))
    if param_drift is not None:
        # factors are evaluated at the final (post-batch-snap) arrival times;
        # invalid rows carry out-of-horizon sentinels but are masked out of
        # every trace column below, so their factors are irrelevant
        f = param_drift(torch.clamp(t_arr, max=horizon))
        params = DeploymentParams(lam=params.lam * f.lam,
                                  mu=params.mu * f.mu,
                                  sig=params.sig * f.sig)
    lam, mu, sig = params.lam, params.mu, params.sig

    c0 = 1.0 + poisson(sig)

    # -- observation window (censored spontaneous-shutdown clock) -----------
    expo = torch.empty(d, dtype=F32, device=device).exponential_(
        generator=gen)
    t_spont = expo / (priors.delta * mu)
    t_left = torch.clamp(horizon - t_arr, min=0.0)
    obs_window = torch.minimum(t_spont, t_left)
    spont_death = (t_spont < t_left) & valid

    # -- scale-out event stream ---------------------------------------------
    valid_f = valid.to(F32)
    so_rate = scaleout_rate(DeploymentParams(lam, mu, sig), priors)
    n_so = poisson(so_rate * obs_window * valid_f)
    n_buf = torch.clamp(n_so, max=float(e))
    ev_valid = torch.arange(e, device=device)[None, :] < n_buf[:, None]
    # the unused buffer tail is masked before sorting (as the arrival times):
    # the valid prefix is then n_buf sorted iid uniforms
    u_ev = torch.where(ev_valid, uniform(d, e), 2.0)
    ev_offsets = torch.sort(u_ev, dim=1).values * obs_window[:, None]
    ev_sizes = (1.0 + poisson(sig[:, None].expand(d, e).contiguous())
                ) * ev_valid
    buf_cores = torch.sum(ev_sizes, dim=1)
    tail = n_so - n_buf                       # events beyond the buffer
    tail_cores = tail + poisson(tail * sig)
    scaleout_cores = buf_cores + tail_cores

    # -- core-death observables (counts exact, exposure Rao-Blackwellized) --
    p0, x0 = _expected_exposure_frac(mu, obs_window, uniform_window=False)
    d0 = torch.binomial(c0 * valid_f, p0, generator=gen)
    ps, xs = _expected_exposure_frac(mu, obs_window, uniform_window=True)
    ds = torch.binomial(scaleout_cores * valid_f, ps, generator=gen)
    n_core_deaths = d0 + ds
    core_hours = (c0 * x0 + scaleout_cores * xs) * valid_f

    z = lambda a: torch.where(valid, a, 0.0).to(F32)
    return WorkloadTrace(
        arrival_hours=torch.where(valid, t_arr, horizon).to(F32),
        c0=z(c0),
        valid=valid,
        lam=z(lam), mu=torch.where(valid, mu, 1.0).to(F32),
        sig=z(sig),
        obs_window=z(obs_window),
        spont_death=spont_death,
        n_core_deaths=z(n_core_deaths),
        core_hours=z(core_hours),
        n_scaleouts=z(n_so),
        scaleout_cores=z(scaleout_cores),
        events=ScaleoutEvents(
            t_offset=(ev_offsets * ev_valid).to(F32),
            cores=ev_sizes.to(F32),
            valid=ev_valid & valid[:, None]),
        horizon_hours=torch.tensor(horizon, dtype=F32, device=device),
    )


# ---------------------------------------------------------------------------
# Scenario registry: name -> synthesis recipe
# ---------------------------------------------------------------------------

class Scenario(NamedTuple):
    name: str
    describe: str
    synth: Callable[[torch.Generator, TraceSpec], WorkloadTrace]


_SCENARIOS: dict[str, Scenario] = {}


def register_scenario(name: str, describe: str = ""):
    """Decorator: register ``fn(gen, spec) -> WorkloadTrace`` under ``name``."""
    def deco(fn):
        if name in _SCENARIOS:
            raise ValueError(f"scenario {name!r} already registered")
        _SCENARIOS[name] = Scenario(name, describe or (fn.__doc__ or "").strip(),
                                    fn)
        return fn
    return deco


def get_scenario(name: str) -> Scenario:
    if name not in _SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; known: {scenario_names()}")
    return _SCENARIOS[name]


def scenario_names() -> tuple[str, ...]:
    return tuple(_SCENARIOS)


def synthesize_scenario(gen_or_seed, name: str, spec: TraceSpec, *,
                        device="cuda") -> WorkloadTrace:
    """Scenario ``name`` drawn from a ``torch.Generator`` (on its device) or
    from a fresh generator seeded with an int on ``device`` (the card unless
    the caller passes ``"cpu"``)."""
    if isinstance(gen_or_seed, torch.Generator):
        gen = gen_or_seed
    else:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(
            int(gen_or_seed))
    log.debug("synthesize_scenario %r: horizon=%gh rate=%g max_deployments=%d",
              name, spec.horizon_hours, spec.arrival_rate,
              spec.max_deployments)
    return get_scenario(name).synth(gen, spec)


@register_scenario("baseline")
def _baseline(gen, spec):
    """Stationary Azure-like workload straight from the priors."""
    return synthesize_trace(gen, spec)


_DIURNAL_DEPTH = 0.75


def diurnal_profile(t: torch.Tensor) -> torch.Tensor:
    """The diurnal scenario's rate multiplier: 1 + 0.75 sin(2 pi t / 24)."""
    return 1.0 + _DIURNAL_DEPTH * torch.sin(2.0 * math.pi * t / 24.0)


@register_scenario("diurnal")
def _diurnal(gen, spec):
    """Sinusoidal day/night arrival-rate modulation (same average rate)."""
    return synthesize_trace(gen, spec, rate_profile=diurnal_profile)


_FLASH_MULT = 8.0
_FLASH_WINDOWS = ((0.30, 24.0), (0.70, 24.0))  # (start frac, duration hours)


def flash_profile(horizon_hours: float):
    """The flash-crowd scenario's rate multiplier: 8x in two 24 h windows."""
    def profile(t):
        m = torch.ones_like(t)
        for frac, dur in _FLASH_WINDOWS:
            start = frac * horizon_hours
            m = torch.where((t >= start) & (t < start + dur), _FLASH_MULT, m)
        return m
    return profile


@register_scenario("flash_crowd")
def _flash_crowd(gen, spec):
    """Two 24h flash-crowd bursts at 8x the base arrival rate."""
    return synthesize_trace(gen, spec,
                            rate_profile=flash_profile(spec.horizon_hours))


@register_scenario("heavy_tail")
def _heavy_tail(gen, spec):
    """10% of deployments live 10x longer (mu scaled down) — lifetime
    inflation à la the heavy-tail regimes of Psychas & Ghaderi."""
    return synthesize_trace(gen, spec, heavy_frac=0.1, heavy_mu_scale=0.1)


@register_scenario("batched")
def _batched(gen, spec):
    """Correlated batch arrivals: groups of 4 deployments submitted at the
    same instant with shared latent parameters."""
    return synthesize_trace(gen, spec, batch_size=4, batch_share_params=True)


# -- drifting (non-stationary-prior) scenarios ------------------------------
#
# Both drift scenarios modulate mu DOWNWARD (deployments live longer), the
# dangerous direction: offered load grows, so a stationary-tuned operating
# point silently slides past its SLA — the regime tuning/drift.py detects
# and re-tunes out of. The terminal regime is itself a stationary prior
# (mu scaled by the constant below), recoverable via ``drifted_priors``.

#: terminal mu multiplier of the drift scenarios (lifetimes 1/scale longer)
DRIFT_MU_SCALE = 0.4
#: drift_ramp: mu ramps linearly between these horizon fractions
DRIFT_RAMP_FRACS = (0.25, 0.55)
#: drift_step: mu steps at this horizon fraction
DRIFT_STEP_FRAC = 0.5


def drift_mu_ramp(t: torch.Tensor, horizon_hours: float) -> torch.Tensor:
    """The drift_ramp mu multiplier at time t: 1 → DRIFT_MU_SCALE linearly
    over the DRIFT_RAMP_FRACS span, constant outside it."""
    a, b = DRIFT_RAMP_FRACS
    frac = torch.clamp((t / horizon_hours - a) / (b - a), 0.0, 1.0)
    return 1.0 + (DRIFT_MU_SCALE - 1.0) * frac


def drift_mu_step(t: torch.Tensor, horizon_hours: float) -> torch.Tensor:
    """The drift_step mu multiplier at time t: 1 before the step fraction,
    DRIFT_MU_SCALE after."""
    return torch.where(t >= DRIFT_STEP_FRAC * horizon_hours,
                       DRIFT_MU_SCALE, 1.0)


def drifted_priors(priors: PopulationPriors,
                   mu_scale: float = DRIFT_MU_SCALE) -> PopulationPriors:
    """The stationary priors of the fully-drifted regime: mu scaled by
    ``mu_scale`` means Gamma(shape, rate / mu_scale)."""
    return priors._replace(mu_rate=priors.mu_rate / mu_scale)


def _mu_only(factor: torch.Tensor) -> DeploymentParams:
    one = torch.ones_like(factor)
    return DeploymentParams(lam=one, mu=factor, sig=one)


@register_scenario("drift_ramp")
def _drift_ramp(gen, spec):
    """Slow multi-month prior drift: mu ramps down to DRIFT_MU_SCALE over
    the middle of the horizon (deployments arriving later live ~2.5x
    longer), holding the drifted regime thereafter."""
    return synthesize_trace(
        gen, spec,
        param_drift=lambda t: _mu_only(drift_mu_ramp(t, spec.horizon_hours)))


@register_scenario("drift_step")
def _drift_step(gen, spec):
    """Abrupt prior change: mu steps down to DRIFT_MU_SCALE at mid-horizon
    — the detection-delay scenario."""
    return synthesize_trace(
        gen, spec,
        param_drift=lambda t: _mu_only(drift_mu_step(t, spec.horizon_hours)))
