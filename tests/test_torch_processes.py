"""The port's deployment processes and belief updates.

Belief updates are deterministic: they get elementwise parity with the JAX
package at rtol 1e-6 on numpy-made inputs. The samplers draw from
``torch.Generator``s, whose bits differ from ``jax.random``'s, so they get
distribution tests: the sample mean and variance of ``N`` draws against the
analytic values, within ``Z`` standard errors (the variance's standard error
from the fourth central moment), and two-sample tests against the JAX
package's own draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from repro.core import AZURE_PRIORS
from repro.core import belief as RB
from repro.core import processes as RP
from repro.sim import draw_arrival_stream as r_draw_arrival_stream
from repro.sim import make_config
from repro_torch import bridge
from repro_torch.core import belief as PB
from repro_torch.core.processes import (DeploymentParams, sample_params,
                                        sample_step_events)
from repro_torch.sim import draw_arrival_stream
from torch_lockstep import port_config
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PRIORS = AZURE_PRIORS
T_PRIORS = bridge.from_reference(PRIORS)
N = 200_000     # draws per distribution test
Z = 5.0         # z-bound: a false alarm per test has probability < 1e-6


def _belief(s, seed):
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(0.5 * rng.standard_normal(s))
                      ).astype(np.float32)
    return RB.GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                          lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))


def _close(got, want, rtol_lam_b=1e-6):
    for name, g, w in zip(got._fields, got, want):
        rtol = rtol_lam_b if name == "lam_b" else 1e-6
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   err_msg=name)


def test_belief_from_prior():
    want = RB.belief_from_prior(PRIORS, (3, 4))
    got = PB.belief_from_prior(T_PRIORS, (3, 4))
    assert all(g.dtype == torch.float32 and g.shape == (3, 4) for g in got)
    _close(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_update_on_events(seed):
    s = 64
    rng = np.random.default_rng(100 + seed)
    bel = _belief(s, seed)
    cores = rng.poisson(6.0, s).astype(np.float32)
    alive = (rng.random(s) < 0.7).astype(np.float32)
    deaths = np.minimum(rng.poisson(1.0, s), cores).astype(np.float32)
    n_so = rng.poisson(0.5, s).astype(np.float32)
    obs = dict(core_deaths=deaths, exposure_core_hours=cores * 6.0 * alive,
               n_scaleouts=n_so,
               scaleout_cores=(n_so + rng.poisson(2.0, s)).astype(np.float32),
               alive_hours=(6.0 * alive).astype(np.float32))
    want = RB.update_on_events(RB.GammaBelief(*map(jnp.asarray, bel)),
                               priors=PRIORS,
                               **{k: jnp.asarray(v) for k, v in obs.items()})
    got = PB.update_on_events(bridge.from_reference(bel), priors=T_PRIORS,
                              **{k: torch.from_numpy(v)
                                 for k, v in obs.items()})
    # lam_b adds E[mu^nu] = exp(lgamma(a+nu) - lgamma(a) - nu log b): the two
    # packages' float32 lgamma differ by an ulp or two, which exp turns into
    # up to ~1.2e-6 relative (seen: 1.19e-6); every other field is to 1e-6
    _close(got, want, rtol_lam_b=2e-6)


def test_observe_initial_size():
    bel = _belief(32, 7)
    c0 = (1.0 + np.random.default_rng(7).poisson(4.0, 32)).astype(np.float32)
    want = RB.observe_initial_size(RB.GammaBelief(*map(jnp.asarray, bel)),
                                   jnp.asarray(c0))
    got = PB.observe_initial_size(bridge.from_reference(bel),
                                  torch.from_numpy(c0))
    _close(got, want)


def _check_moments(x, mean, var, fourth_central=None):
    """Sample mean and variance of ``x`` within Z standard errors."""
    x = x.to(torch.float64).numpy().ravel()
    n = x.size
    assert abs(x.mean() - mean) <= Z * np.sqrt(var / n), (x.mean(), mean)
    if fourth_central is not None:
        se_var = np.sqrt(max(fourth_central - var**2, 0.0) / n)
        assert abs(x.var() - var) <= Z * se_var, (x.var(), var)


def test_sample_params_gamma_moments():
    gen = torch.Generator().manual_seed(0)
    p = sample_params(gen, T_PRIORS, (N,))
    assert all(x.dtype == torch.float32 and x.shape == (N,) for x in p)
    for x, k, rate in ((p.lam, PRIORS.lam_shape, PRIORS.lam_rate),
                       (p.mu, PRIORS.mu_shape, PRIORS.mu_rate),
                       (p.sig, PRIORS.sig_shape, PRIORS.sig_rate)):
        var = k / rate**2
        # Gamma(k): fourth central moment 3 k (k + 2) / rate^4
        _check_moments(x, k / rate, var, 3 * k * (k + 2) / rate**4)


@pytest.mark.parametrize("lam,mu,sig,cores", [(0.4, 0.02, 3.0, 8.0),
                                              (2.5, 0.3, 0.5, 30.0)])
def test_sample_step_events_moments(lam, mu, sig, cores):
    dt = 6.0
    gen = torch.Generator().manual_seed(int(cores))
    full = lambda v: torch.full((N,), v, dtype=torch.float32)
    params = DeploymentParams(lam=full(lam), mu=full(mu), sig=full(sig))
    ev = sample_step_events(gen, params, full(cores), T_PRIORS, dt,
                            alive=torch.ones(N, dtype=torch.bool))
    p_die = -np.expm1(-mu * dt)
    _check_moments(ev.core_deaths, cores * p_die, cores * p_die * (1 - p_die))
    q = -np.expm1(-PRIORS.delta * mu * dt)
    assert ev.spont_death.dtype == torch.bool
    _check_moments(ev.spont_death.float(), q, q * (1 - q))
    r = lam * mu**PRIORS.nu * dt
    _check_moments(ev.n_scaleouts, r, r, r + 3 * r * r)   # Poisson(r)
    # k + Poisson(k sig) with k ~ Poisson(r): a compound Poisson total
    _check_moments(ev.scaleout_cores, r * (1 + sig),
                   r * (1 + sig)**2 + r * sig)
    assert bool(torch.all(ev.scaleout_cores >= ev.n_scaleouts))


def test_dead_slots_draw_no_events():
    gen = torch.Generator().manual_seed(1)
    full = lambda v: torch.full((1_000,), v, dtype=torch.float32)
    params = DeploymentParams(lam=full(5.0), mu=full(0.5), sig=full(2.0))
    ev = sample_step_events(gen, params, full(10.0), T_PRIORS, 6.0,
                            alive=torch.zeros(1_000, dtype=torch.bool))
    assert float(ev.core_deaths.abs().sum()) == 0.0
    assert float(ev.n_scaleouts.sum()) == 0.0
    assert float(ev.scaleout_cores.sum()) == 0.0


KS_P = 1e-4     # a false alarm per comparison has probability 1e-4


def _same_law(got, want, name):
    """Two-sample Kolmogorov-Smirnov: the port's draws and the JAX
    package's come from one distribution (p above KS_P)."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    p = ks_2samp(got, want).pvalue
    assert p > KS_P, (name, p, got.mean(), want.mean())


@pytest.mark.parametrize("part", ["params", "stream", "events"])
def test_samplers_match_reference_in_distribution(part):
    """The port's samplers against the JAX package's own, in law: deployment
    parameters from the priors; the arrival stream (true parameters, initial
    sizes, arrivals a step) at the ``quick`` preset's rates over 40,000
    steps; and one step's events for N deployments drawn from the priors.
    With the step equal on the same draws (``test_torch_sim.py``), this is
    what makes the two packages' Monte-Carlo results one estimator."""
    gen = torch.Generator().manual_seed(0)
    if part == "params":
        got = sample_params(gen, T_PRIORS, (N,))
        want = RP.sample_params(jax.random.PRNGKey(0), PRIORS, (N,))
        for name in got._fields:
            _same_law(getattr(got, name).numpy(), getattr(want, name), name)
    elif part == "stream":
        cfg = make_config(capacity=5_000.0, arrival_rate=0.25,
                          horizon_hours=40_000 * 12.0, dt=12.0, max_slots=64,
                          max_arrivals=5)
        got = draw_arrival_stream(gen, port_config(cfg))
        want = r_draw_arrival_stream(jax.random.PRNGKey(1), cfg)
        for name in ("c0", "n_arrivals"):
            _same_law(getattr(got, name).numpy(), getattr(want, name), name)
        for name in got.params._fields:
            _same_law(getattr(got.params, name).numpy(),
                      getattr(want.params, name), name)
    else:
        params = sample_params(gen, T_PRIORS, (N,))
        cores = 1.0 + torch.poisson(torch.full((N,), 5.0), generator=gen)
        alive = torch.ones(N, dtype=torch.bool)
        got = sample_step_events(gen, params, cores, T_PRIORS, 6.0,
                                 alive=alive)
        want = RP.sample_step_events(
            jax.random.PRNGKey(2),
            RP.DeploymentParams(*(jnp.asarray(x.numpy()) for x in params)),
            jnp.asarray(cores.numpy()), PRIORS, 6.0,
            alive=jnp.asarray(alive.numpy()))
        for name in got._fields:
            _same_law(getattr(got, name).numpy(), getattr(want, name), name)
