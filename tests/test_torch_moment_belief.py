"""The belief form of the port's moment-curve kernels, on the CPU.

* The ``ops`` entry points (belief columns in: on the CPU, ``pack_belief``
  and the packed plain versions) against the JAX package's ``ops`` entry
  points in interpret mode, on numpy-made beliefs, at the JAX package's
  kernel tolerances (EL rtol 2e-4 / atol 1e-5, VL rtol 2e-3 / atol 1e-4).
* ``ref.pack_in_kernel_order``, the belief kernel's in-register pack op for
  op in float32 with its scalars rounded once on the host, bit for bit
  against ``pack_belief``.
* ``ref.agg_in_kernel_order``, the aggregate kernel's order of summation,
  against the plain version at the same tolerances.
* The belief launchers refuse what the kernels cannot take, and the
  admission core derives the D-term interpolation once, not every step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS
from repro.core.belief import GammaBelief
from repro.kernels.moment_curves import ops as ROPS
from repro_torch import bridge
from repro_torch.core import SECOND, geometric_grid, make_policy
from repro_torch.kernels.moment_curves import kernel as PK
from repro_torch.kernels.moment_curves import ops as POPS
from repro_torch.kernels.moment_curves import ref as PREF
from repro_torch.sim import make_config, make_run

T_PRIORS = bridge.from_reference(AZURE_PRIORS)
TOL_EL = dict(rtol=2e-4, atol=1e-5)
TOL_VL = dict(rtol=2e-3, atol=1e-4)


def _beliefs(d, n, seed, shape_scale=1.0):
    """numpy beliefs, cores, alive and grid of ``d`` slots."""
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(rng.standard_normal(d))).astype(np.float32)
    bel = GammaBelief(mu_a=e(0.31 * shape_scale), mu_b=e(0.58),
                      lam_a=e(0.49), lam_b=e(0.45), sig_a=e(0.26),
                      sig_b=e(0.055))
    cores = (1.0 + rng.poisson(5.0, d)).astype(np.float32)
    alive = rng.random(d) < 0.6
    grid = np.exp(np.linspace(np.log(1.0), np.log(26_000.0), n)
                  ).astype(np.float32)
    return bel, cores, alive, grid


@pytest.mark.parametrize("nd", [8, 24, 32])
@pytest.mark.parametrize("n", [12, 48])
@pytest.mark.parametrize("d", [1, 8, 37, 300, 8193])
@pytest.mark.parametrize("which", ["rows", "agg"])
def test_entry_points_match_jax_kernels(which, d, n, nd):
    bel, cores, alive, grid = _beliefs(d, n, seed=d * 100 + n + nd)
    rbel = GammaBelief(*map(jnp.asarray, bel))
    tbel = bridge.from_reference(bel)
    t_cores, t_grid = torch.from_numpy(cores), torch.from_numpy(grid)
    if which == "rows":
        want = ROPS.moment_curves_kernel(rbel, jnp.asarray(cores),
                                         jnp.asarray(grid), AZURE_PRIORS,
                                         d_points=nd, interpret=True)
        got = POPS.moment_curves_kernel(tbel, t_cores, t_grid, T_PRIORS,
                                        d_points=nd)
    else:
        want = ROPS.aggregate_moment_curves_kernel(
            rbel, jnp.asarray(cores), jnp.asarray(alive), jnp.asarray(grid),
            AZURE_PRIORS, d_points=nd, interpret=True)
        got = POPS.aggregate_moment_curves_kernel(
            tbel, t_cores, torch.from_numpy(alive), t_grid, T_PRIORS,
            d_points=nd)
    np.testing.assert_allclose(got.EL.numpy(), np.asarray(want.EL), **TOL_EL)
    np.testing.assert_allclose(got.VL.numpy(), np.asarray(want.VL), **TOL_VL)


@pytest.mark.parametrize("nu", [AZURE_PRIORS.nu, 0.5, 1.3])
@pytest.mark.parametrize("d,seed,shape_scale", [
    (1, 0, 1.0), (37, 1, 1.0), (8193, 2, 1.0),
    # posterior shapes of 30-3,000, where lgamma(a+p) - lgamma(a) cancels
    (4096, 3, 1e3)])
def test_pack_in_kernel_order_is_pack_belief_bit_for_bit(d, seed,
                                                         shape_scale, nu):
    priors = T_PRIORS._replace(nu=nu)
    bel, cores, alive, _ = _beliefs(d, 4, seed, shape_scale)
    tbel = bridge.from_reference(bel)
    t_cores, t_alive = torch.from_numpy(cores), torch.from_numpy(alive)
    want = PREF.pack_rows(tbel, t_cores, priors, alive=t_alive)
    got = PREF.pack_in_kernel_order(tbel, t_cores,
                                    PREF.pack_constants(priors),
                                    alive=t_alive)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_pack_constants_round_once_from_double():
    k = PREF.pack_constants(T_PRIORS)
    nu = T_PRIORS.nu
    assert k == PREF.PackConstants(
        nu=float(np.float32(nu)), nu_m1=float(np.float32(nu - 1.0)),
        two_nu=float(np.float32(2.0 * nu)),
        two_nu_m2=float(np.float32(2.0 * nu - 2.0)),
        delta=float(np.float32(T_PRIORS.delta)))
    # rounding nu first and subtracting in float32 gives another float here
    assert k.nu_m1 != float(np.float32(np.float32(nu) - np.float32(1.0)))


@pytest.mark.parametrize("d,ctas", [(1, 1), (37, 1), (8193, 129), (8193, 5),
                                    (8193, 1)])
def test_agg_reduction_order_matches_plain_version(d, ctas):
    bel, cores, alive, grid = _beliefs(d, 48, seed=d + ctas)
    tbel = bridge.from_reference(bel)
    t_cores, t_alive = torch.from_numpy(cores), torch.from_numpy(alive)
    t, idx, frac, nd = POPS.curve_grid(torch.from_numpy(grid), 24)
    el, vl = PREF.moment_curves_belief_ref(tbel, t_cores, t, idx, frac, nd,
                                           T_PRIORS)
    got_el, got_vl = PREF.agg_in_kernel_order(el, vl, t_alive.float(), ctas)
    want_el, want_vl = PREF.moment_curves_agg_belief_ref(
        tbel, t_cores, t_alive, t, idx, frac, nd, T_PRIORS)
    torch.testing.assert_close(got_el, want_el, **TOL_EL)
    torch.testing.assert_close(got_vl, want_vl, **TOL_VL)


def _inputs(d=8, n=12, nd=8):
    bel, cores, alive, grid = _beliefs(d, n, seed=0)
    t, idx, frac, _ = POPS.curve_grid(torch.from_numpy(grid), nd)
    return dict(bel=bridge.from_reference(bel), cores=torch.from_numpy(cores),
                alive=torch.from_numpy(alive), t=t, idx=idx, frac=frac,
                nd=nd)


def _with_mu_a(fix):
    return lambda a: a["bel"]._replace(mu_a=fix(a["bel"].mu_a))


@pytest.mark.parametrize("which", ["rows", "agg"])
@pytest.mark.parametrize("field, fix, error", [
    ("bel", _with_mu_a(lambda x: x.double()), TypeError),
    ("bel", _with_mu_a(lambda x: x[:-1]), ValueError),
    ("bel", _with_mu_a(lambda x: torch.empty(x.shape, device="meta")),
     ValueError),
    ("bel", _with_mu_a(lambda x: torch.stack([x, x], 1)[:, 0]), ValueError),
    ("cores", lambda a: a["cores"].to(torch.int32), TypeError),
    ("cores", lambda a: torch.cat([a["cores"], a["cores"][:1]]), ValueError),
    ("idx", lambda a: a["idx"].long(), TypeError),
    ("t", lambda a: a["t"][:-1], ValueError),
    ("nd", lambda a: 0, ValueError),
    ("nd", lambda a: 33, ValueError),
])
def test_belief_launchers_refuse_bad_inputs(which, field, fix, error):
    args = _inputs()
    args[field] = fix(args)
    with pytest.raises(error):
        _belief_launch(which, args)


@pytest.mark.parametrize("fix, error", [
    (lambda a: a["alive"].float(), TypeError),
    (lambda a: a["alive"][:-1], ValueError),
    (lambda a: torch.empty(a["alive"].shape, dtype=torch.bool,
                           device="meta"), ValueError),
])
def test_agg_belief_launcher_refuses_bad_alive(fix, error):
    args = _inputs()
    args["alive"] = fix(args)
    with pytest.raises(error):
        _belief_launch("agg", args)


def test_agg_belief_launcher_refuses_more_than_256_points():
    """Since the chunked aggregate, the belief form takes any N (on the
    card in chunks of at most 256 points; on the CPU its plain version in
    one call, equal to the packed plain version); the packed form, the TPU
    kernel's interface, still refuses more than 256."""
    a = _inputs(n=257)
    el, vl = _belief_launch("agg", a)
    assert el.shape == vl.shape == (257,)
    want = PREF.moment_curves_agg_belief_ref(
        a["bel"], a["cores"], a["alive"], a["t"], a["idx"], a["frac"],
        a["nd"], T_PRIORS)
    assert torch.equal(el, want[0]) and torch.equal(vl, want[1])
    assert PK.agg_chunks(257) == [(0, 256), (256, 257)]
    assert PK.agg_chunks(256) == [(0, 256)]
    params = PREF.pack_rows(a["bel"], a["cores"], T_PRIORS, alive=a["alive"])
    with pytest.raises(ValueError):
        PK.moment_curves_agg_packed(params, a["t"], a["idx"], a["frac"],
                                    a["nd"])


def _belief_launch(which, a):
    if which == "rows":
        return PK.moment_curves_belief(a["bel"], a["cores"], a["t"], a["idx"],
                                       a["frac"], a["nd"], T_PRIORS)
    return PK.moment_curves_agg_belief(a["bel"], a["cores"], a["alive"],
                                       a["t"], a["idx"], a["frac"], a["nd"],
                                       T_PRIORS)


def test_belief_launchers_take_the_plain_versions_on_cpu_without_counting():
    a = _inputs(d=37, n=12, nd=8)
    PK.reset_launches()
    el, vl = _belief_launch("rows", a)
    ael, avl = _belief_launch("agg", a)
    assert set(PK.LAUNCHES.values()) == {0}
    mask = a["alive"].float()
    torch.testing.assert_close(ael, mask @ el, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(avl, mask @ vl, rtol=1e-6, atol=0.0)


def test_interp_points_derived_once_per_admission_core(monkeypatch):
    calls = []
    real = POPS.interp_points

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(POPS, "interp_points", counting)
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=24 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    assert cfg.n_steps == 24
    assert cfg.use_kernel and cfg.agg_backend == "kernel"
    run = make_run(cfg, geometric_grid(24.0, 3 * 24 * 24.0, 12), SECOND,
                   device="cpu")
    m = run(1, make_policy(SECOND, rho=0.05, capacity=cfg.capacity))
    assert float(m.arrivals_accepted) > 0
    assert len(calls) == 1


def test_entry_points_derive_a_grid_once():
    a = _inputs(d=8, n=12, nd=8)
    grid = torch.from_numpy(_beliefs(8, 12, seed=0)[3])
    first = POPS._grid_of(grid, 8)
    assert POPS._grid_of(grid, 8) is first
    assert POPS._grid_of(grid, 24) is not first
    grid.mul_(1.0)                      # an in-place write: derived anew
    assert POPS._grid_of(grid, 8) is not first
    with torch.inference_mode():
        frozen = grid.clone()
    assert POPS._grid_of(frozen, 8) is not POPS._grid_of(frozen, 8)
    got = POPS.moment_curves_kernel(a["bel"], a["cores"], grid, T_PRIORS,
                                    d_points=8)
    want = PREF.moment_curves_belief_ref(a["bel"], a["cores"],
                                         *POPS.curve_grid(grid, 8), T_PRIORS)
    assert torch.equal(got.EL, want[0]) and torch.equal(got.VL, want[1])
