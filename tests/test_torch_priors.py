"""The port's §6–§7 priors against the JAX package's.

Pseudo observations are drawn by each package's own generator, so they are
compared in law (two-sample Kolmogorov-Smirnov, per field, at k = 1, 5 and
50); the port draws each sum directly (Gamma(k)/mu, Poisson(k rate),
Poisson(k sig)) where the JAX package sums k draws. The folds are
deterministic and compared on the JAX package's own observations. Every
field but ``lam_b`` is an exact float32 sum and must be equal. ``lam_b``
adds E[mu^nu] = exp(lgamma(a+nu) - lgamma(a) - nu log b), whose float32
terms the two packages round differently by ulps of their values, which
grow with a: it is held to rtol 2e-6 (``update_on_events``' bound) plus 4
float32 ulps (2^-23 relative) of each of the three terms. Measured on 10^5
beliefs: 2.7e-6 at a ~ 1.3, 7.6e-5 at a ~ 50 (where the JAX package's own
error against float64 is 6.1e-5, the port's 1.7e-5), 5.9e-3 at a ~ 3,000.
The arrival streams of the §6 and §7 modes are compared in law field by
field.
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
from repro_torch.core import processes as PP
from repro_torch.sim import MIX_LABELED, MIX_UNLABELED, PSEUDO
from repro_torch.sim import draw_arrival_stream
from torch_lockstep import port_config
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PRIORS = AZURE_PRIORS
T_PRIORS = bridge.from_reference(PRIORS)
N = 20_000      # deployments a comparison in law
KS_P = 1e-4     # a false alarm per comparison has probability 1e-4
RTOL_FOLD = 2e-6


def _same_law(got, want, name):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    p = ks_2samp(got, want).pvalue
    assert p > KS_P, (name, p, got.mean(), want.mean())


def _params(n, seed):
    """``n`` deployments: 8 drawn from the priors (numpy), each repeated."""
    rng = np.random.default_rng(seed)
    draw = lambda shape, rate: (rng.gamma(shape, 1.0 / rate, 8)
                                .astype(np.float32))
    base = dict(lam=draw(PRIORS.lam_shape, PRIORS.lam_rate),
                mu=draw(PRIORS.mu_shape, PRIORS.mu_rate),
                sig=draw(PRIORS.sig_shape, PRIORS.sig_rate))
    return RP.DeploymentParams(**{k: np.tile(v, n // 8)
                                  for k, v in base.items()})


@pytest.mark.parametrize("k", [1, 5, 50])
def test_sample_pseudo_observations_match_reference_in_law(k):
    params = _params(N, k)
    want = RP.sample_pseudo_observations(
        jax.random.PRNGKey(k), RP.DeploymentParams(*map(jnp.asarray, params)),
        PRIORS, k)
    gen = torch.Generator().manual_seed(k)
    got = PP.sample_pseudo_observations(gen, bridge.from_reference(params),
                                        T_PRIORS, k)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if name in ("n_lifetimes", "n_windows", "n_sizes"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            # per deployment of the 8, whose laws differ
            for d in range(8):
                _same_law(g.numpy()[d::8], w[d::8], f"{name}[{d}]")


def test_zero_pseudo_observations_are_uninformative():
    params = bridge.from_reference(_params(16, 0))
    obs = PP.sample_pseudo_observations(torch.Generator(), params, T_PRIORS,
                                        0)
    assert all(float(x.abs().sum()) == 0.0 for x in obs)
    bel = PB.belief_from_prior(T_PRIORS, (16,))
    after = PB.apply_pseudo_observations(bel, obs, T_PRIORS)
    for a, b in zip(after, bel):
        assert torch.equal(a, b)


def _belief(s, seed):
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(0.5 * rng.standard_normal(s))
                      ).astype(np.float32)
    return RB.GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                          lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))


def _lam_b_rtol(bel):
    """Per element: rtol 2e-6 plus 4 float32 ulps of each term of log
    E[mu^nu] at the folded belief (see the module docstring)."""
    a, b = (x.to(torch.float64) for x in (bel.mu_a, bel.mu_b))
    scale = (torch.lgamma(a + PRIORS.nu).abs() + torch.lgamma(a).abs()
             + (PRIORS.nu * torch.log(b)).abs())
    return (RTOL_FOLD + 4 * 2.0**-23 * scale).numpy()


def _close(got, want):
    """Every field equal but ``lam_b``, which is held to ``_lam_b_rtol``."""
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name != "lam_b":
            np.testing.assert_array_equal(g, w, err_msg=name)
    g, w = got.lam_b.numpy().astype(np.float64), np.asarray(want.lam_b)
    rel = np.abs(g - w) / np.abs(w)
    assert (rel <= _lam_b_rtol(got)).all(), rel.max()


@pytest.mark.parametrize("k", [1, 5, 50])
def test_apply_pseudo_observations_on_reference_draws(k):
    """The fold on the JAX package's own observations: mu_a reaches 50.3
    and the sums the hundreds and more at k = 50."""
    s = 4_096
    params = _params(s, 100 + k)
    obs = RP.sample_pseudo_observations(
        jax.random.PRNGKey(100 + k),
        RP.DeploymentParams(*map(jnp.asarray, params)), PRIORS, k)
    bel = _belief(s, k)
    want = RB.apply_pseudo_observations(
        RB.GammaBelief(*map(jnp.asarray, bel)), obs, PRIORS)
    got = PB.apply_pseudo_observations(
        bridge.from_reference(bel),
        bridge.from_reference(jax.tree.map(np.asarray, obs)), T_PRIORS)
    _close(got, want)


def test_pseudo_counts_from_observables_clip_malformed_rows():
    rng = np.random.default_rng(3)
    s = 256
    cols = dict(core_deaths=rng.poisson(3.0, s),
                exposure_core_hours=rng.gamma(2.0, 50.0, s),
                n_scaleouts=rng.poisson(1.0, s),
                scaleout_cores=rng.poisson(4.0, s),
                window_hours=rng.gamma(2.0, 20.0, s))
    cols = {k: v.astype(np.float32) for k, v in cols.items()}
    # malformed rows: negative counts, exposures and windows, and fewer
    # scale-out cores than scale-outs
    for i, name in enumerate(cols):
        cols[name][i::7] *= -1.0
    cols["scaleout_cores"][3::11] = 0.0
    want = RB.pseudo_counts_from_observables(
        **{k: jnp.asarray(v) for k, v in cols.items()})
    got = PB.pseudo_counts_from_observables(
        **{k: torch.from_numpy(v) for k, v in cols.items()})
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert (g >= 0.0).all(), name
    bel = _belief(s, 9)
    folded = PB.apply_pseudo_observations(bridge.from_reference(bel), got,
                                          T_PRIORS)
    r_folded = RB.apply_pseudo_observations(
        RB.GammaBelief(*map(jnp.asarray, bel)), want, PRIORS)
    _close(folded, r_folded)
    assert all(bool(torch.isfinite(x).all()) for x in folded)


STREAM_CFG = dict(capacity=5_000.0, arrival_rate=0.25,
                  horizon_hours=4_000 * 12.0, dt=12.0, max_slots=64,
                  max_arrivals=5)


@pytest.mark.parametrize("mode, k", [(PSEUDO, 1), (PSEUDO, 50),
                                     (MIX_LABELED, 5), (MIX_UNLABELED, 5)])
def test_arrival_streams_match_reference_in_law(mode, k):
    """The §6/§7 arrival streams (4,000 steps of 5 arrivals) against the JAX
    package's, field by field in law; the mixture's second component is an
    independent type with its own observations and, as in the JAX package,
    has not seen the request size; outside the mixtures ``bel_alt`` is the
    belief before the request size."""
    cfg = make_config(prior_mode=mode, n_pseudo_obs=k, **STREAM_CFG)
    want = r_draw_arrival_stream(jax.random.PRNGKey(k), cfg)
    got = draw_arrival_stream(torch.Generator().manual_seed(k),
                              port_config(cfg))
    for part in ("params", "bel", "bel_alt"):
        for name in getattr(got, part)._fields:
            g = getattr(getattr(got, part), name).numpy()
            w = np.asarray(getattr(getattr(want, part), name))
            assert g.shape == w.shape and g.dtype == w.dtype
            if name == "mu_a" or (name == "sig_b"):
                # deterministic: the prior plus k (plus one for C0)
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           err_msg=f"{part}.{name}")
            else:
                _same_law(g, w, f"{part}.{name}")
    np.testing.assert_array_equal(got.bel.sig_b.numpy(),
                                  (got.bel_alt.sig_b + 1.0).numpy())
    if mode == PSEUDO:
        # one type: bel_alt is bel before C0
        np.testing.assert_array_equal(got.bel_alt.mu_b.numpy(),
                                      got.bel.mu_b.numpy())


def test_global_stream_draws_are_unchanged_by_the_modes():
    """The GLOBAL draws come first and in the same order in every mode, so
    a seed gives the same arrivals, true parameters and sizes in all."""
    streams = {mode: draw_arrival_stream(
        torch.Generator().manual_seed(3),
        port_config(make_config(prior_mode=mode, n_pseudo_obs=n,
                                **STREAM_CFG)))
        for mode, n in (("global", 0), (PSEUDO, 5), (MIX_UNLABELED, 5))}
    base = streams["global"]
    for s in streams.values():
        assert torch.equal(s.n_arrivals, base.n_arrivals)
        assert torch.equal(s.c0, base.c0)
        for a, b in zip(s.params, base.params):
            assert torch.equal(a, b)
