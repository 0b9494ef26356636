"""The port's §7–§8 pricing, the POMDP bounds, the discrete moment forms
and the unlabeled candidates, against the JAX package's.

Inputs are made with numpy seeds and handed to both packages. Tolerances:
elementwise forms with no cancellation (payment, the means of a mixture,
the bounds) rtol 1e-6; a mixture's variance ``second - e**2`` cancels where
one component dominates, so it is held to 4 float32 ulps of ``second``
(the JAX package's CPU compiler may contract it into a fused multiply-add,
eager PyTorch does not); the discrete moment forms rtol 1e-5 against the
JAX package's and against the float64 O(N²) oracle, the bound of
``tests/test_moments.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, belief_from_prior
from repro.core import moments as RM
from repro.core import pomdp as RPO
from repro.core import pricing as RPR
from repro.core.belief import GammaBelief
from repro.sim import make_admission_core as r_make_admission_core
from repro.sim import make_config
from repro.testing import given, settings, strategies as st
from repro_torch import bridge
from repro_torch.core import geometric_grid
from repro_torch.core import moments as PM
from repro_torch.core import pomdp as PPO
from repro_torch.core import pricing as PPR
from repro_torch.core.moments import MomentCurves
from repro_torch.sim import MIX_UNLABELED
from repro_torch.sim import make_admission_core
from torch_lockstep import port_config
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PRIORS = AZURE_PRIORS
T_PRIORS = bridge.from_reference(PRIORS)
RTOL = 1e-6
RTOL_DISCRETE = 1e-5
ULP = 2.0**-23


def _curves(k, shape, seed, dominant=False):
    """K components' curves [K, *shape] as numpy float32; with
    ``dominant`` the first component's mean is 1e3 times the others'."""
    rng = np.random.default_rng(seed)
    el = rng.gamma(2.0, 50.0, (k, *shape)).astype(np.float32)
    vl = (el * rng.gamma(2.0, 5.0, (k, *shape))).astype(np.float32)
    if dominant:
        el[0] *= 1e3
    return el, vl


@pytest.mark.parametrize("k, shape, dominant", [(2, (5, 32), False),
                                                (2, (3, 5, 48), True),
                                                (3, (7,), False)])
def test_mixture_moments(k, shape, dominant):
    el, vl = _curves(k, shape, k * 10 + len(shape), dominant)
    w = np.random.default_rng(k).dirichlet(np.ones(k)).astype(np.float32)
    want = RPR.mixture_moments(jnp.asarray(w),
                               RM.MomentCurves(jnp.asarray(el),
                                               jnp.asarray(vl)))
    got = PPR.mixture_moments(torch.from_numpy(w),
                              MomentCurves(torch.from_numpy(el),
                                           torch.from_numpy(vl)))
    np.testing.assert_allclose(got.EL.numpy(), np.asarray(want.EL),
                               rtol=RTOL)
    second = (w.reshape((-1,) + (1,) * len(shape))
              * (vl.astype(np.float64) + el.astype(np.float64) ** 2)).sum(0)
    err = np.abs(got.VL.numpy().astype(np.float64) - np.asarray(want.VL))
    assert (err <= 4 * ULP * second).all(), (err / second).max()
    assert (got.VL.numpy() >= 0.0).all()


def test_mixture_moments_exact_and_weights_as_a_tuple():
    curves = MomentCurves(EL=torch.tensor([[2.0], [6.0]]),
                          VL=torch.tensor([[1.0], [3.0]]))
    mix = PPR.mixture_moments((0.5, 0.5), curves)
    assert float(mix.EL[0]) == 4.0
    assert float(mix.VL[0]) == 6.0     # E[V] + V[E] = 2 + 4


@settings(max_examples=50, deadline=None)
@given(e1=st.floats(0.0, 100.0), e2=st.floats(0.0, 100.0),
       v1=st.floats(0.0, 100.0), v2=st.floats(0.0, 100.0),
       p=st.floats(0.01, 0.99))
def test_prop4_mixture_variance_excess_nonneg(e1, e2, v1, v2, p):
    """Prop. 4 / the law of total variance: Var(mix) >= weighted Var, and
    the excess equals the JAX package's."""
    w = [p, 1 - p]
    got = PPR.mixture_variance_excess(torch.tensor(w), torch.tensor([e1, e2]),
                                      torch.tensor([v1, v2]))
    want = RPR.mixture_variance_excess(jnp.asarray(w), jnp.asarray([e1, e2]),
                                       jnp.asarray([v1, v2]))
    assert float(got) >= -1e-6
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)


def test_payment_and_variance_estimate():
    el, vl = _curves(2, (9, 24), 5)
    c0 = (1.0 + np.random.default_rng(5).poisson(4.0, (2, 9))).astype(
        np.float32)
    want_v = RPR.variance_estimate(RM.MomentCurves(jnp.asarray(el),
                                                   jnp.asarray(vl)))
    got_v = PPR.variance_estimate(MomentCurves(torch.from_numpy(el),
                                               torch.from_numpy(vl)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for kw in ({}, dict(kappa1=2.0, kappa2=0.05)):
        want = RPR.payment(jnp.asarray(c0), want_v, **kw)
        got = PPR.payment(torch.from_numpy(c0), got_v, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_labeling_lowers_the_variance_charge():
    """Cor. 2: the unlabeled mixture's variance is at least the weighted
    mean of the labeled components' at every horizon point, up to the
    float32 cancellation in ``second - e**2`` (4 ulps of ``second``)."""
    el, vl = _curves(2, (64, 32), 8)
    curves = MomentCurves(torch.from_numpy(el), torch.from_numpy(vl))
    mix = PPR.mixture_moments((0.5, 0.5), curves)
    labeled = 0.5 * (curves.VL[0] + curves.VL[1])
    second = 0.5 * (curves.VL + curves.EL**2).sum(0)
    assert bool((mix.VL >= labeled - 4 * ULP * second).all())


def _aggregates(seed, n=48):
    rng = np.random.default_rng(seed)
    el = rng.gamma(2.0, 4_000.0, n).astype(np.float32)
    el[::7] = 25_000.0                  # the mean beyond capacity
    vl = (el * rng.gamma(2.0, 30.0, n)).astype(np.float32)
    return el, vl


@pytest.mark.parametrize("capacity", [20_000.0, 5_000])
def test_pomdp_bounds(capacity):
    el, vl = _aggregates(int(capacity))
    tel, tvl = torch.from_numpy(el), torch.from_numpy(vl)
    for name in ("markov_bound", "cantelli_bound", "failure_bound"):
        args = (el,) if name == "markov_bound" else (el, vl)
        targs = (tel,) if name == "markov_bound" else (tel, tvl)
        want = getattr(RPO, name)(*map(jnp.asarray, args), capacity)
        got = getattr(PPO, name)(*targs, capacity)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   err_msg=name)
    cant = PPO.cantelli_bound(tel, tvl, capacity).numpy()
    assert (cant[el >= capacity] == 1.0).all()
    assert ((cant >= 0.0) & (cant <= 1.0)).all()
    assert (PPO.failure_bound(tel, tvl, capacity).numpy()
            <= cant * (1 + ULP)).all()
    assert PPO.SLAConfig() == tuple(RPO.SLAConfig())
    assert PPO.SLAConfig._fields == RPO.SLAConfig._fields


def _posterior():
    return GammaBelief(mu_a=jnp.asarray(2.31), mu_b=jnp.asarray(40.0),
                       lam_a=jnp.asarray(3.49), lam_b=jnp.asarray(9.4),
                       sig_a=jnp.asarray(4.26), sig_b=jnp.asarray(3.05))


@pytest.mark.parametrize("n_steps, dt, belief, cores", [
    (8, 1.0, "prior", 5.0), (24, 2.0, "prior", 5.0), (50, 12.0, "prior", 5.0),
    (20, 4.0, "posterior", 17.0)])
def test_moment_curves_discrete(n_steps, dt, belief, cores):
    """``tests/test_moments.py``'s cases: the prefix-sum form against the
    JAX package's (float32 both) and against the O(N²) float64 oracle."""
    bel = (belief_from_prior(PRIORS) if belief == "prior"
           else _posterior())
    bel = GammaBelief(*(jnp.asarray(x, jnp.float32) for x in bel))
    t_bel = bridge.from_reference(GammaBelief(*map(np.asarray, bel)))
    got = PM.moment_curves_discrete(t_bel, torch.tensor(cores), n_steps, dt,
                                    T_PRIORS)
    want = RM.moment_curves_discrete(bel, jnp.asarray(cores, jnp.float32),
                                     n_steps, dt, PRIORS)
    oracle = PM.moment_curves_discrete_naive(
        GammaBelief(*map(float, bel)), cores, n_steps, dt, T_PRIORS)
    r_oracle = RM.moment_curves_discrete_naive(bel, cores, n_steps, dt,
                                               PRIORS)
    for name in ("EL", "VL"):
        g = getattr(got, name)
        assert g.dtype == torch.float32 and tuple(g.shape) == (n_steps,)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL_DISCRETE, err_msg=name)
        np.testing.assert_allclose(g.numpy(), getattr(oracle, name),
                                   rtol=RTOL_DISCRETE, err_msg=name)
        np.testing.assert_allclose(getattr(oracle, name),
                                   getattr(r_oracle, name), rtol=1e-12,
                                   err_msg=name)


def test_moment_curves_discrete_batched_rows_are_the_rows_alone():
    rng = np.random.default_rng(4)
    e = lambda base: torch.from_numpy(
        (base * np.exp(0.5 * rng.standard_normal(6))).astype(np.float32))
    bel = PM.GammaBelief(mu_a=e(2.0), mu_b=e(40.0), lam_a=e(3.0),
                         lam_b=e(9.0), sig_a=e(4.0), sig_b=e(3.0))
    cores = torch.from_numpy(rng.poisson(8.0, 6).astype(np.float32))
    rows = PM.moment_curves_discrete(bel, cores, 30, 6.0, T_PRIORS)
    for i in range(6):
        one = PM.moment_curves_discrete(PM.GammaBelief(*(x[i] for x in bel)),
                                        cores[i], 30, 6.0, T_PRIORS)
        np.testing.assert_allclose(rows.EL[i].numpy(), one.EL.numpy(),
                                   rtol=RTOL)
        np.testing.assert_allclose(rows.VL[i].numpy(), one.VL.numpy(),
                                   rtol=RTOL)


# ---------------------------------------------------------------------------
# The unlabeled mode's candidates: both components in one row-kernel call.
# ---------------------------------------------------------------------------

MIX_CFG = dict(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
               dt=24.0, max_slots=96, max_arrivals=4, d_points=8,
               prior_mode=MIX_UNLABELED, n_pseudo_obs=5)


def _mix_stream(seed, runs=None):
    """The unlabeled mode's arrival stream of one run ([T, A] leaves) or of
    ``runs`` runs ([R, T, A])."""
    from repro_torch.sim import draw_arrival_stream

    cfg = port_config(make_config(**MIX_CFG))
    draw = lambda s: draw_arrival_stream(torch.Generator().manual_seed(s),
                                         cfg)
    if runs is None:
        return cfg, draw(seed)
    return cfg, _map(lambda *xs: torch.stack(xs),
                     *(draw(seed + r) for r in range(runs)))


def _map(fn, *trees):
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _step(stream, t):
    """Step t's slice of a stream of one run or of R runs."""
    batch = stream.n_arrivals.ndim == 2
    return _map(lambda x: x[:, t] if batch else x[t], stream)


@pytest.mark.parametrize("runs", [None, 3])
def test_unlabeled_candidates_one_call_equals_two(runs, monkeypatch):
    """The 2 A rows (2 R A for R runs) of both components go through one
    row-kernel call (its plain version on the CPU), whose bits equal one
    call a component; the mixture is ``pricing.mixture_moments``. The rows
    are stacked once a run (``candidate_rows``, as ``make_run`` does): the
    call reads views of them, with no copy a step, and a step's rows built
    alone equal the run's."""
    from repro_torch.kernels.moment_curves import ops
    from repro_torch.sim import core as sim_core

    cfg, stream = _mix_stream(11, runs)
    if runs is not None:    # [R, T, A] -> [T, R, A], as make_run steps it
        stream = _map(lambda x: x.movedim(0, 1).contiguous(), stream)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    calls = []
    real = ops.moment_curves_kernel

    def counted(bel, cores, *args, **kw):
        calls.append((tuple(cores.shape), cores.data_ptr(),
                      tuple(x.data_ptr() for x in bel)))
        return real(bel, cores, *args, **kw)

    monkeypatch.setattr(sim_core, "_make_curves_fn", lambda cfg: counted)
    core = make_admission_core(cfg, grid, 2, device="cpu")
    rows = core.candidate_rows(stream)
    lead = (4,) if runs is None else (runs, 4)
    flat = lambda x: x.reshape(-1)
    for t in range(cfg.n_steps):
        st_t = _map(lambda x: x[t], stream)
        rows_t = _map(lambda x: x[t], rows)
        alone = core.candidate_rows(st_t)
        for got_x, want_x in zip(_leaves(alone), _leaves(rows_t)):
            assert torch.equal(got_x, want_x)
        calls.clear()
        got = core.candidates(rows_t)
        assert calls == [((2 * int(np.prod(lead)),), rows_t.c0.data_ptr(),
                          tuple(x.data_ptr() for x in rows_t.bel))]
        one = [real(PM.GammaBelief(*map(flat, bel)), flat(st_t.c0), grid,
                    cfg.priors, d_points=cfg.d_points)
               for bel in (st_t.bel, st_t.bel_alt)]
        want = PPR.mixture_moments((0.5, 0.5), MomentCurves(
            *(torch.stack([a, b]).reshape(2, *lead, -1)
              for a, b in zip(*one))))
        assert torch.equal(got.EL, want.EL) and torch.equal(got.VL, want.VL)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [y for x in tree for y in _leaves(x)]
    return [tree]


def test_unlabeled_candidates_match_reference():
    """The port's unlabeled candidates against the JAX package's candidates
    function on the same stream (the JAX package's fused curves, the port's
    row kernel's plain version), at ``tests/test_kernels.py``'s kernel
    tolerances."""
    from repro.core.belief import GammaBelief as RGammaBelief
    from repro.sim.core import ArrivalStream as RArrivalStream

    cfg = make_config(**MIX_CFG)
    grid = np.asarray(geometric_grid(24.0, 3 * 30 * 24.0, 12))
    _, stream = _mix_stream(5)
    r_core = r_make_admission_core(cfg, jnp.asarray(grid), 2)
    core = make_admission_core(port_config(cfg), grid, 2, device="cpu")
    for t in range(0, cfg.n_steps, 3):
        st_t = _step(stream, t)
        r_bel = lambda b: RGammaBelief(*(jnp.asarray(x.numpy()) for x in b))
        r_st = RArrivalStream(params=None, c0=jnp.asarray(st_t.c0.numpy()),
                              bel=r_bel(st_t.bel), bel_alt=r_bel(st_t.bel_alt),
                              n_arrivals=None)
        want = r_core.candidates(r_st)
        got = core.candidates(core.candidate_rows(st_t))
        np.testing.assert_allclose(got.EL.numpy(), np.asarray(want.EL),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got.VL.numpy(), np.asarray(want.VL),
                                   rtol=2e-3, atol=1e-4)
