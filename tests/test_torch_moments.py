"""The port's moment curves against the JAX package's, on the same inputs.

Beliefs, cores and alive masks are made with numpy seeds and handed to both
packages (the grid crosses through ``repro_torch.bridge``). Tolerance: rtol
1e-5 (VL also atol 1e-8), as between the JAX package's own fused and
per-slot paths (tests/test_aggregate_fastpath.py): the closed forms are the
same, the order of float operations is not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, geometric_grid
from repro.core import moments as R
from repro.core.belief import GammaBelief
from repro_torch import bridge
from repro_torch.core import geometric_grid as t_geometric_grid
from repro_torch.core import moments as P
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PRIORS = AZURE_PRIORS
T_PRIORS = bridge.from_reference(PRIORS)
RTOL = 1e-5
ATOL_VL = 1e-8


def _case(s, seed):
    """Belief, cores and alive of ``s`` slots, as numpy arrays."""
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(0.5 * rng.standard_normal(s))
                      ).astype(np.float32)
    bel = GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                      lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))
    cores = (1.0 + rng.poisson(5.0, s)).astype(np.float32)
    alive = rng.random(s) < 0.6
    return bel, cores, alive


def _both(s, seed, n):
    bel, cores, alive = _case(s, seed)
    grid = np.asarray(geometric_grid(6.0, 26_280.0, n))
    ref = (GammaBelief(*map(jnp.asarray, bel)), jnp.asarray(cores),
           jnp.asarray(alive), jnp.asarray(grid))
    port = (bridge.from_reference(bel), torch.from_numpy(cores),
            torch.from_numpy(alive), bridge.from_reference(grid))
    return ref, port


def _close(got, want, vl=False):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL_VL if vl else 0.0)


@pytest.mark.parametrize("t_min,t_max,n", [(1.0, 26_280.0, 48),
                                           (6.0, 78_840.0, 48),
                                           (24.0, 2_160.0, 12),
                                           (12.0, 32_850.0, 24)])
def test_geometric_grid(t_min, t_max, n):
    """Both packages interpolate log t in float32 and exponentiate. XLA's
    float32 division is not IEEE-rounded, so a log-space point may differ by
    one ulp, which exp turns into up to ~1.2e-6 relative at log t ~ 11
    (t ~ 80,000 h): hence rtol 2e-6 on the grid, and 2e-7 on log t."""
    got = t_geometric_grid(t_min, t_max, n).numpy()
    want = np.asarray(geometric_grid(t_min, t_max, n))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=2e-7)


def test_pack_belief():
    (bel, cores, _, _), (t_bel, t_cores, _, _) = _both(64, 0, 12)
    want = R.pack_belief(bel, cores, PRIORS)
    got = P.pack_belief(t_bel, t_cores, T_PRIORS)
    assert got._fields == want._fields
    for name, w in want._asdict().items():
        _close(getattr(got, name), w)


@pytest.mark.parametrize("n,nd", [(12, 8), (24, 16), (48, 24), (48, 32)])
def test_interp_matrix(n, nd):
    grid = np.asarray(geometric_grid(6.0, 26_280.0, n))
    want = R.interp_matrix(jnp.asarray(grid), nd)
    got = P.interp_matrix(bridge.from_reference(grid), nd)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("s,n,nd", [(64, 12, 8), (37, 48, 24), (16, 24, 32)])
@pytest.mark.parametrize("fn", ["moment_curves", "moment_curves_fused"])
def test_per_slot_curves(fn, s, n, nd):
    (bel, cores, _, grid), (t_bel, t_cores, _, t_grid) = _both(s, s + n, n)
    want = jax.jit(getattr(R, fn), static_argnums=3,
                   static_argnames="d_points")(bel, cores, grid, PRIORS,
                                               d_points=nd)
    got = getattr(P, fn)(t_bel, t_cores, t_grid, T_PRIORS, d_points=nd)
    _close(got.EL, want.EL)
    _close(got.VL, want.VL, vl=True)


@pytest.mark.parametrize("s,n,nd", [(64, 16, 8), (700, 24, 16),
                                    (1100, 12, 8)])
def test_aggregate_moment_curves(s, n, nd):
    """S = 700 and 1,100 take the padded path of 512-slot blocks folded left
    to right."""
    (bel, cores, alive, grid), (t_bel, t_cores, t_alive, t_grid) = \
        _both(s, s, n)
    want = jax.jit(R.aggregate_moment_curves, static_argnums=4,
                   static_argnames="d_points")(bel, cores, alive, grid,
                                               PRIORS, d_points=nd)
    got = P.aggregate_moment_curves(t_bel, t_cores, t_alive, t_grid,
                                    T_PRIORS, d_points=nd)
    _close(got.EL, want.EL)
    _close(got.VL, want.VL, vl=True)


@pytest.mark.parametrize("s", [64, 700])
def test_masked_curve_reduction(s):
    rng = np.random.default_rng(s)
    el = rng.gamma(2.0, 3.0, (s, 12)).astype(np.float32)
    vl = rng.gamma(2.0, 9.0, (s, 12)).astype(np.float32)
    mask = (rng.random(s) < 0.6).astype(np.float32)
    want = R.masked_curve_reduction(
        R.MomentCurves(jnp.asarray(el), jnp.asarray(vl)), jnp.asarray(mask))
    got = P.masked_curve_reduction(
        P.MomentCurves(torch.from_numpy(el), torch.from_numpy(vl)),
        torch.from_numpy(mask))
    _close(got.EL, want.EL)
    _close(got.VL, want.VL, vl=True)


def test_aggregate_equals_masked_reduction_of_fused():
    """Within the port, the fused aggregate is the masked reduction of the
    fused per-slot curves, bit for bit (same block split, same fold)."""
    _, (t_bel, t_cores, t_alive, t_grid) = _both(700, 5, 12)
    per_slot = P.moment_curves_fused(t_bel, t_cores, t_grid, T_PRIORS,
                                     d_points=8)
    red = P.masked_curve_reduction(per_slot, t_alive.to(torch.float32))
    agg = P.aggregate_moment_curves(t_bel, t_cores, t_alive, t_grid,
                                    T_PRIORS, d_points=8)
    np.testing.assert_array_equal(red.EL.numpy(), agg.EL.numpy())
    np.testing.assert_array_equal(red.VL.numpy(), agg.VL.numpy())


def test_expected_mu_pow():
    bel, _, _ = _case(32, 3)
    want = GammaBelief(*map(jnp.asarray, bel)).expected_mu_pow(PRIORS.nu)
    got = bridge.from_reference(bel).expected_mu_pow(PRIORS.nu)
    _close(got, want)
