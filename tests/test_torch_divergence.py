"""Replays of the first decisions at which the port leaves the JAX package
on its own draws, at the ``quick`` preset (seed 0).

``tests/torch_divergence.py`` stepped both packages on the JAX package's
draws (the witness's runs, ``tests/torch_table2_witness.py``) and saved the
JAX package's state for the first step whose decisions differ:

* FIRST, theta 1,000: step 1,034, run 1, candidate 1 (refresh at 1,032);
* SECOND, rho 0.08137: step 201, run 7, candidate 4 (refresh at 200).

Each file holds the slot table the last refresh read and the aggregate the
JAX package's refresh gave, the aggregate that step's decisions read, the
step's candidates, and the JAX package's decisions, scores and bounds.

The replay shows that the decisions differ only because the two packages'
float32 ``lgamma`` differ at large posterior shape (``pack_belief``'s
Gamma(a+p)/Gamma(a) as exp(lgamma(a+p) - lgamma(a)); mu_a reaches 1,456
and 6,096 in these tables), and that the JAX package's margin lies inside
the gap that makes:

1. on the JAX package's own aggregate, the port's admission takes the JAX
   package's decisions (the policies' arithmetic is the same);
2. the port's refresh of the saved slot table differs from the JAX
   package's by at most the documented gap (``GAP``, ROADMAP.md Queue C);
3. with the JAX package's ``lgamma`` values in place of the port's, the
   port's refresh agrees with the JAX package's to float32 rounding of the
   rest (``AGREE``), and the port then takes the JAX package's decisions;
4. the JAX package's margin (bound - score over the bound) at the
   candidate where the trace saw the decisions part lies inside the
   documented gap; with its own ``lgamma``, the port takes the JAX
   package's decisions, or every decision it takes otherwise has a JAX
   margin inside that gap.

The candidates placed between the refresh and the step enter the port's
aggregate as the JAX package's own increment (the aggregate the step read
minus the refreshed one).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaln

from repro_torch.core import AZURE_PRIORS, PolicyParams
from repro_torch.core.belief import GammaBelief
from repro_torch.core.moments import MomentCurves, aggregate_moment_curves
from repro_torch.core.policies import admit_sequential_verbose

DATA = pathlib.Path(__file__).parent / "data"
CASES = {"first": "torch_divergence_quick_first.npz",
         "second": "torch_divergence_quick_second.npz"}
#: the candidate at which the trace found the two packages' decisions part
PARTED = {"first": 1, "second": 4}
#: the packages' refreshed-aggregate gap documented in ROADMAP.md Queue C
#: for these two steps: E[L] 5.6e-4 and V[L] 1.04e-2 relative (largest
#: over the grid), measured with this replay; the bound is that, rounded up
GAP = {"el": 1e-3, "vl": 2e-2}
#: the refreshes with one lgamma: E[L] to 2e-7 and V[L] to 7.5e-5 (the
#: rest of the form's float32 rounding, amplified by V's cancellations)
AGREE = {"el": 1e-6, "vl": 1e-4}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _load(name):
    z = np.load(DATA / CASES[name])
    t = lambda k: torch.from_numpy(np.array(z[k]))
    return z, t


def _refresh(z, t):
    """The port's refresh (the fused lane the witness's runs use) of the
    saved slot table."""
    bel = GammaBelief(*(t(f"refresh_bel_{k}") for k in GammaBelief._fields))
    return aggregate_moment_curves(bel, t("refresh_cores"), t("refresh_alive"),
                                   t("grid"), AZURE_PRIORS,
                                   d_points=int(z["d_points"]))


def _decide(z, t, agg_el, agg_vl):
    policy = PolicyParams(*(t(f"policy_{k}") for k in PolicyParams._fields))
    valid = torch.arange(z["c0"].shape[0]) < int(z["n_arrivals"])
    res, diag = admit_sequential_verbose(
        policy, agg_el, agg_vl, t("util"),
        MomentCurves(t("cand_el"), t("cand_vl")), t("c0"), valid)
    return res.accept.numpy(), diag


def _at_step(z, refreshed):
    """The aggregate the step reads: a refresh plus the JAX package's
    increment since its own refresh."""
    inc = lambda k: torch.from_numpy(z[k] - z[f"refresh_{k}"])
    return refreshed.EL + inc("agg_el"), refreshed.VL + inc("agg_vl")


def _jax_lgamma(x):
    return torch.from_numpy(np.array(jax.jit(gammaln)(jnp.asarray(
        x.numpy()))))


@pytest.mark.parametrize("name", list(CASES))
def test_divergence_is_the_lgamma_gap(name, monkeypatch):
    z, t = _load(name)
    want = z["accept"]

    # 1. the same aggregate gives the same decisions (the Cantelli mass to
    #    2 float32 ulps: the JAX package's compiler may fuse a multiply-add)
    accept, diag = _decide(z, t, t("agg_el"), t("agg_vl"))
    np.testing.assert_array_equal(accept, want)
    np.testing.assert_allclose(diag.score.numpy(), z["score"],
                               rtol=2 * 2.0**-23, atol=0)

    # 2. the packages' refreshes differ by at most the documented gap
    own = _refresh(z, t)
    gap = dict(el=_rel(own.EL, z["refresh_agg_el"]),
               vl=_rel(own.VL, z["refresh_agg_vl"]))
    assert gap["el"] <= GAP["el"] and gap["vl"] <= GAP["vl"], gap

    # 3. with one lgamma they agree, and so do the decisions
    with monkeypatch.context() as m:
        m.setattr(torch, "lgamma", _jax_lgamma)
        same = _refresh(z, t)
    agree = dict(el=_rel(same.EL, z["refresh_agg_el"]),
                 vl=_rel(same.VL, z["refresh_agg_vl"]))
    assert agree["el"] <= AGREE["el"] and agree["vl"] <= AGREE["vl"], agree
    accept, _ = _decide(z, t, *_at_step(z, same))
    np.testing.assert_array_equal(accept, want)

    # 4. the saved step parted inside the documented gap; with its own
    #    lgamma the port takes the same decisions, or a JAX margin inside
    #    that gap at every one that differs
    margin = (z["bound"] - z["score"]) / z["bound"]
    gap_of_score = GAP["el"] if name == "first" else GAP["vl"]
    assert abs(margin[PARTED[name]]) < gap_of_score, margin[PARTED[name]]
    accept, _ = _decide(z, t, *_at_step(z, own))
    for a in np.nonzero(accept != want)[0]:
        assert abs(margin[a]) < gap_of_score, (a, margin[a])
