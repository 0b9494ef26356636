"""The plain versions of the port's moment-curve kernels against the JAX
package's Pallas kernels (run with ``interpret=True``, as its own tests run
them on the CPU), on identical packed inputs; and the port's ``ops`` entry
points on the CPU against the JAX package's ``ops`` in interpret mode.

Tolerance: rtol 2e-4 / atol 1e-5 on EL and rtol 2e-3 / atol 1e-4 on VL, the
JAX package's own kernel tolerances (tests/test_kernels.py): the port's
plain versions take the cumprod directly and interpolate from two
checkpoints where the TPU kernel takes exp∘cumsum∘log and a hat-weight
matmul.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS
from repro.core.belief import GammaBelief
from repro.kernels.moment_curves import kernel as RK
from repro.kernels.moment_curves import ops as ROPS
from repro_torch import bridge
from repro_torch.kernels.moment_curves import kernel as PK
from repro_torch.kernels.moment_curves import ops as POPS
from repro_torch.kernels.moment_curves import ref as PREF
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PRIORS = AZURE_PRIORS
T_PRIORS = bridge.from_reference(PRIORS)
TOL_EL = dict(rtol=2e-4, atol=1e-5)
TOL_VL = dict(rtol=2e-3, atol=1e-4)
# the shapes of tests/test_kernels.py
SHAPES = [(1, 8, 8), (37, 48, 32), (300, 33, 16), (512, 64, 32)]


def _case(d, n, seed):
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(rng.standard_normal(d))).astype(np.float32)
    bel = GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                      lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))
    cores = (1.0 + rng.poisson(5.0, d)).astype(np.float32)
    alive = rng.random(d) < 0.6
    grid = np.exp(np.linspace(np.log(1.0), np.log(26_000.0), n)
                  ).astype(np.float32)
    return bel, cores, alive, grid


def _packed(d, n, nd, seed):
    """The reference's packed rows (padded to its block) and grids, and the
    port's launcher inputs built from the same rows."""
    bel, cores, alive, grid = _case(d, n, seed)
    rbel = GammaBelief(*map(jnp.asarray, bel))
    params, _ = ROPS._pack(rbel, jnp.asarray(cores), PRIORS,
                           alive=jnp.asarray(alive))
    tc, tau, w_mat = ROPS._grids(jnp.asarray(grid), nd)
    ref_in = (params, jnp.asarray(grid)[None, :], tc, tau, w_mat)
    port_in = (torch.from_numpy(np.array(params)),
               *POPS.curve_grid(torch.from_numpy(grid), nd)[:3])
    return ref_in, port_in


@pytest.mark.parametrize("d,n,nd", SHAPES)
def test_rows_plain_version_matches_pallas_kernel(d, n, nd):
    ref_in, port_in = _packed(d, n, nd, seed=d + n)
    want_el, want_vl = RK.moment_curves_packed(*ref_in, nd=nd,
                                               interpret=True)
    got_el, got_vl = PREF.moment_curves_packed_ref(*port_in, nd)
    np.testing.assert_allclose(got_el.numpy(), np.asarray(want_el), **TOL_EL)
    np.testing.assert_allclose(got_vl.numpy(), np.asarray(want_vl), **TOL_VL)


@pytest.mark.parametrize("d,n,nd", SHAPES)
def test_agg_plain_version_matches_pallas_kernel(d, n, nd):
    ref_in, port_in = _packed(d, n, nd, seed=d + n + 1)
    want_el, want_vl = RK.moment_curves_agg_packed(*ref_in, nd=nd,
                                                   interpret=True)
    got_el, got_vl = PREF.moment_curves_agg_packed_ref(*port_in, nd)
    np.testing.assert_allclose(got_el.numpy(), np.asarray(want_el)[0],
                               **TOL_EL)
    np.testing.assert_allclose(got_vl.numpy(), np.asarray(want_vl)[0],
                               **TOL_VL)


@pytest.mark.parametrize("d,n,nd", [(37, 48, 24)])
def test_ops_entry_points_on_cpu(d, n, nd):
    bel, cores, alive, grid = _case(d, n, seed=7 * d)
    rbel = GammaBelief(*map(jnp.asarray, bel))
    tbel = bridge.from_reference(bel)
    want = ROPS.moment_curves_kernel(rbel, jnp.asarray(cores),
                                     jnp.asarray(grid), PRIORS, d_points=nd,
                                     interpret=True)
    got = POPS.moment_curves_kernel(tbel, torch.from_numpy(cores),
                                    torch.from_numpy(grid), T_PRIORS,
                                    d_points=nd)
    np.testing.assert_allclose(got.EL.numpy(), np.asarray(want.EL), **TOL_EL)
    np.testing.assert_allclose(got.VL.numpy(), np.asarray(want.VL), **TOL_VL)
    want = ROPS.aggregate_moment_curves_kernel(
        rbel, jnp.asarray(cores), jnp.asarray(alive), jnp.asarray(grid),
        PRIORS, d_points=nd, interpret=True)
    got = POPS.aggregate_moment_curves_kernel(
        tbel, torch.from_numpy(cores), torch.from_numpy(alive),
        torch.from_numpy(grid), T_PRIORS, d_points=nd)
    np.testing.assert_allclose(got.EL.numpy(), np.asarray(want.EL), **TOL_EL)
    np.testing.assert_allclose(got.VL.numpy(), np.asarray(want.VL), **TOL_VL)


def test_launchers_take_the_plain_versions_on_cpu_without_counting():
    _, (params, t, idx, frac) = _packed(37, 12, 8, seed=3)
    PK.reset_launches()
    el, vl = PK.moment_curves_packed(params, t, idx, frac, 8)
    ael, avl = PK.moment_curves_agg_packed(params, t, idx, frac, 8)
    assert set(PK.LAUNCHES.values()) == {0}
    mask = params[:, PREF.ALIVE]
    np.testing.assert_allclose(ael.numpy(), (mask @ el).numpy(), rtol=1e-6)
    np.testing.assert_allclose(avl.numpy(), (mask @ vl).numpy(), rtol=1e-6)


@pytest.mark.parametrize("bad, error", [
    (dict(params=lambda p: p.double()), TypeError),
    (dict(params=lambda p: p[:, :15]), ValueError),
    (dict(idx=lambda i: i.long()), TypeError),
    (dict(t=lambda t: t[:-1]), ValueError),
    (dict(nd=33), ValueError),
    (dict(nd=0), ValueError),
    (dict(t=lambda t: torch.ones(257)), ValueError),
])
def test_launchers_reject_bad_inputs(bad, error):
    _, (params, t, idx, frac) = _packed(8, 12, 8, seed=0)
    args = dict(params=params, t=t, idx=idx, frac=frac)
    for name, fix in bad.items():
        if name != "nd":
            args[name] = fix(args[name])
    nd = bad.get("nd", 8)
    with pytest.raises(error):
        PK.moment_curves_agg_packed(args["params"], args["t"], args["idx"],
                                    args["frac"], nd)
