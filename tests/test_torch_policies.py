"""The port's admission rules against the JAX package's, on the same inputs.

Aggregates, candidate curves and sizes are made with numpy seeds. Each
threshold (or Cantelli bound) is set a stated distance from the score it is
compared with, so no decision lies within 1e-4 relative of its bound: there
the decisions must be exactly equal. Scores and folded aggregates agree to
rtol 1e-6 (the same float32 operations, in the same order, per point).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as R
from repro.core.moments import MomentCurves
from repro_torch import bridge
from repro_torch.core import policies as P
from repro_torch.core.moments import MomentCurves as TMomentCurves

KINDS = {"zeroth": R.ZEROTH, "first": R.FIRST, "second": R.SECOND}
CAPACITY = 2_000.0
MIN_MARGIN = 1e-4


def _inputs(seed, n=24, a=6):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    agg_el = f32(np.sort(rng.uniform(400.0, 1_200.0, n))[::-1])
    agg_vl = f32(rng.uniform(1e3, 2e4, n))
    cand_el = f32(rng.gamma(2.0, 40.0, (a, n)))
    cand_vl = f32(rng.gamma(2.0, 900.0, (a, n)))
    if seed % 2:
        cand_el[0, -4:] = 1e-7      # below the marginal heuristic's eps
    c0 = f32(1.0 + rng.poisson(30.0, a))
    util = f32(rng.uniform(800.0, 1_400.0))
    valid = rng.random(a) < 0.8
    return dict(agg_el=agg_el, agg_vl=agg_vl, cand_el=cand_el,
                cand_vl=cand_vl, c0=c0, util=util, valid=valid, rng=rng)


def _policy(kind, bound, marginal):
    kw = dict(rho=bound) if kind == R.SECOND else dict(threshold=bound)
    return R.make_policy(kind, capacity=CAPACITY, marginal=marginal, **kw)


def _ref_score(kind, x, i, marginal):
    """The reference's score for candidate ``i`` against the base aggregate."""
    probe = _policy(kind, 0.5, marginal)
    _, diag = R.decide_scored(probe, jnp.asarray(x["agg_el"]),
                              jnp.asarray(x["agg_vl"]), jnp.asarray(x["util"]),
                              MomentCurves(jnp.asarray(x["cand_el"][i]),
                                           jnp.asarray(x["cand_vl"][i])),
                              jnp.asarray(x["c0"][i]))
    return float(diag.score)


@pytest.mark.parametrize("marginal", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decide_scored(kind, marginal):
    kind = KINDS[kind]
    n_acc = 0
    for seed in range(12):
        x = _inputs(seed)
        for i in range(x["c0"].shape[0]):
            score = _ref_score(kind, x, i, marginal)
            # the bound 1% to 20% above or below the score
            u = x["rng"].uniform(0.01, 0.2) * x["rng"].choice([-1.0, 1.0])
            bound = score * (1.0 + u)
            args = (x["agg_el"], x["agg_vl"], x["util"])
            cand = (x["cand_el"][i], x["cand_vl"][i])
            ref_pol = _policy(kind, bound, marginal)
            want_ok, want = R.decide_scored(
                ref_pol, *map(jnp.asarray, args),
                MomentCurves(*map(jnp.asarray, cand)),
                jnp.asarray(x["c0"][i]))
            policy = bridge.from_reference(
                type(ref_pol)(*map(np.asarray, ref_pol)))
            got_ok, got = P.decide_scored(
                policy, *map(torch.from_numpy, map(np.array, args)),
                TMomentCurves(*map(torch.from_numpy, cand)),
                torch.tensor(x["c0"][i]))
            assert abs(float(want.score) - float(want.threshold)) \
                >= MIN_MARGIN * abs(float(want.threshold))
            assert bool(got_ok) == bool(want_ok)
            assert bool(got.fits) == bool(want.fits)
            assert bool(P.decide(policy, *map(torch.from_numpy,
                                               map(np.array, args)),
                                 TMomentCurves(*map(torch.from_numpy, cand)),
                                 torch.tensor(x["c0"][i]))) == bool(want_ok)
            np.testing.assert_allclose(float(got.score), float(want.score),
                                       rtol=1e-6)
            assert float(got.threshold) == float(want.threshold)
            n_acc += bool(want_ok)
    assert 0 < n_acc < 72      # both outcomes are exercised


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_admit_sequential(kind, seed):
    kind = KINDS[kind]
    x = _inputs(100 + seed)
    # a bound near the middle of the candidates' scores against the base
    # aggregate, so that the running aggregate crosses it within the batch
    scores = [_ref_score(kind, x, i, False) for i in range(x["c0"].shape[0])]
    bound = float(np.median(scores)) * 1.013
    ref_pol = _policy(kind, bound, marginal=seed % 2 == 1)
    res, diag = R.admit_sequential_verbose(
        ref_pol, jnp.asarray(x["agg_el"]), jnp.asarray(x["agg_vl"]),
        jnp.asarray(x["util"]),
        MomentCurves(jnp.asarray(x["cand_el"]), jnp.asarray(x["cand_vl"])),
        jnp.asarray(x["c0"]), jnp.asarray(x["valid"]))
    margin = np.abs(np.asarray(diag.score) - np.asarray(diag.threshold))
    assert np.all(margin >= MIN_MARGIN * np.abs(np.asarray(diag.threshold)))

    policy = bridge.from_reference(type(ref_pol)(*map(np.asarray, ref_pol)))
    t = lambda v: torch.from_numpy(np.array(v))
    got = P.admit_sequential(policy, t(x["agg_el"]), t(x["agg_vl"]),
                             t(x["util"]),
                             TMomentCurves(t(x["cand_el"]), t(x["cand_vl"])),
                             t(x["c0"]), t(x["valid"]))
    got_v, got_diag = P.admit_sequential_verbose(
        policy, t(x["agg_el"]), t(x["agg_vl"]), t(x["util"]),
        TMomentCurves(t(x["cand_el"]), t(x["cand_vl"])), t(x["c0"]),
        t(x["valid"]))
    np.testing.assert_array_equal(got.accept.numpy(), np.asarray(res.accept))
    np.testing.assert_array_equal(got_v.accept.numpy(), np.asarray(res.accept))
    np.testing.assert_allclose(got.agg_el.numpy(), np.asarray(res.agg_el),
                               rtol=1e-6)
    np.testing.assert_allclose(got.agg_vl.numpy(), np.asarray(res.agg_vl),
                               rtol=1e-6)
    assert float(got.util) == float(res.util)
    np.testing.assert_allclose(got_diag.score.numpy(), np.asarray(diag.score),
                               rtol=1e-6)
    # the fit flags alone (the telemetry rider's input): the same decisions
    # and the JAX package's flags
    got_f, fits = P.admit_sequential_fits(
        policy, t(x["agg_el"]), t(x["agg_vl"]), t(x["util"]),
        TMomentCurves(t(x["cand_el"]), t(x["cand_vl"])), t(x["c0"]),
        t(x["valid"]))
    np.testing.assert_array_equal(got_f.accept.numpy(), np.asarray(res.accept))
    np.testing.assert_array_equal(fits.numpy(), np.asarray(diag.fits))
    assert torch.equal(fits, got_diag.fits)


def test_is_safe():
    x = _inputs(5)
    for kind in KINDS.values():
        for bound in (0.05, 0.5, 900.0, 1_300.0):
            ref_pol = _policy(kind, bound, False)
            want = R.is_safe(ref_pol, jnp.asarray(x["agg_el"]),
                             jnp.asarray(x["agg_vl"]))
            policy = bridge.from_reference(
                type(ref_pol)(*map(np.asarray, ref_pol)))
            got = P.is_safe(policy, torch.from_numpy(x["agg_el"]),
                            torch.from_numpy(x["agg_vl"]))
            assert bool(got) == bool(want)


def test_make_policy_matches_reference():
    for kind in KINDS.values():
        want = R.make_policy(kind, threshold=123.5, rho=0.112,
                             capacity=CAPACITY, marginal=True)
        got = P.make_policy(kind, threshold=123.5, rho=0.112,
                            capacity=CAPACITY, marginal=True)
        for g, w in zip(got, want):
            assert g.dtype == torch.from_numpy(np.array(w)).dtype
            assert g.item() == np.asarray(w).item()
