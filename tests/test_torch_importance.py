"""The port's importance sampling (Appendix D) against the JAX package's.

* ``rejection_q`` exact.
* The greedy month schedule, given the JAX package's i^x and lifetime
  clocks, gives the JAX package's ``stream_badness`` bit for bit.
* Both plans, given the JAX package's BM values, choose the same members
  with the same weights, buckets and bucket probabilities;
  ``estimate_from_plan`` is equal on the same metrics.
* A seed's probe stream is its run's stream, bit for bit.
* The point-mass curves (k = 1e6: mu_a = mu * 1e6, far outside float32
  log-gamma's accuracy) are not compared with the JAX package's: the
  port's and the JAX package's E[mu^nu] factors are each held against a
  float64 scipy oracle, and the port must be no worse than the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

from repro.core import geometric_grid
from repro.core.moments import moment_curves_fused as j_curves
from repro.core.moments import pack_belief as j_pack
from repro.sim import draw_arrival_stream, make_config
from repro.sim import importance as RI
from repro_torch import bridge
from repro_torch.core.moments import pack_belief as p_pack
from repro_torch.sim import importance as PI
from repro_torch.sim import PriorArrivalSource, make_run, RunMetrics
from repro_torch.core import SECOND, make_policy
from torch_lockstep import port_config
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

# a month is 730 h: 120 days at dt 24 is 4 months, two arrival slots a step
CFG = make_config(capacity=300.0, arrival_rate=0.2, horizon_hours=120 * 24.0,
                  dt=24.0, max_slots=64, max_arrivals=8, d_points=8)
GRID = geometric_grid(24.0, 3 * 120 * 24.0, 12)
PCFG = port_config(CFG)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_rejection_q_matches_reference():
    for p, p_r in (([0.7, 0.2, 0.1], [0.5, 0.3, 0.0]),
                   ([0.5, 0.5], [0.9, 0.0]),
                   ([0.25, 0.25, 0.25, 0.25], [0.1, 0.2, 0.3, 0.0])):
        np.testing.assert_array_equal(PI.rejection_q(p, p_r),
                                      RI.rejection_q(p, p_r))


def _reference_inputs(keys, cfg, mu_first=None):
    """The JAX package's i^x, lifetime clocks, occupancy and BM of the
    streams of ``keys`` (``stream_badness``'s own arithmetic, step by
    step, eagerly as ``stream_badness`` runs it); ``mu_first`` replaces
    the true mu of the streams' first arrivals."""
    ix, life, occ, bm = [], [], [], []
    for key in keys:
        k_stream, k_scan = jax.random.split(key)
        k_life = jax.random.fold_in(k_scan, 99)
        stream = draw_arrival_stream(k_stream, cfg)
        if mu_first is not None:
            mu = stream.params.mu.at[:len(mu_first), 0].set(
                jnp.asarray(mu_first, jnp.float32))
            stream = stream._replace(params=stream.params._replace(mu=mu),
                                     n_arrivals=jnp.maximum(
                                         stream.n_arrivals, 1))
        t_steps, a_max = stream.c0.shape
        params = jax.tree.map(lambda x: x.reshape(-1), stream.params)
        occurs = (jnp.arange(a_max)[None, :]
                  < stream.n_arrivals[:, None]).reshape(-1)
        curves = j_curves(RI._point_mass(params), stream.c0.reshape(-1),
                          GRID, cfg.priors, d_points=8)
        i_x = jnp.max(curves.EL + jnp.sqrt(99.0 * curves.VL), axis=-1)
        ix.append(np.asarray(jnp.where(occurs, i_x, 0.0)))
        life.append(np.asarray(jax.random.exponential(
            k_life, (t_steps * a_max,)) / (cfg.priors.delta * params.mu)))
        occ.append(np.asarray(occurs))
        bm.append(float(RI.stream_badness(k_life, stream, cfg, GRID)))
    return np.stack(ix), np.stack(life), np.stack(occ), np.asarray(bm)


@pytest.mark.parametrize("capacity", [300.0, 150.0, 60.0])
def test_schedule_matches_reference_bit_for_bit(capacity):
    cfg = CFG._replace(capacity=capacity)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    ix, life, occ, want = _reference_inputs(keys, cfg)
    got = PI.greedy_schedule(ix, life, occ, port_config(cfg))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (want > 1.1 * capacity).any() or capacity == 300.0


def test_schedule_casts_lifetimes_as_reference():
    """Lifetime clocks past int64 months (mu ~ 1e-30: 1/(delta mu) ~ 1e31
    h), infinite (mu = 0) and the i^x they give: the JAX package's int32
    cast saturates, and so must the port's."""
    keys = jax.random.split(jax.random.PRNGKey(6), 3)
    ix, life, occ, want = _reference_inputs(
        keys, CFG, mu_first=[1e-30, 1e-20, 2e-19])
    assert (life > 9.3e18 * 730.0).any()
    got = PI.greedy_schedule(ix, life, occ, PCFG)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _probed(n_probe=48):
    key = jax.random.PRNGKey(21)
    plan = RI.make_importance_plan(key, CFG, GRID, quotas=(3, 2, 2),
                                   edges_frac=(1.0, 1.3), n_probe=n_probe,
                                   probe_batch=16)
    return key, plan


def test_key_plan_from_reference_badness():
    key, want = _probed()
    got = PI.plan_from_badness(want.bm_probe, np.arange(len(want.bm_probe)),
                               PCFG, quotas=(3, 2, 2), edges_frac=(1.0, 1.3))
    probe_keys = np.asarray(jax.random.split(key, len(want.bm_probe)))
    idx = [int(np.nonzero((probe_keys == k).all(axis=1))[0][0])
           for k in want.keys]
    np.testing.assert_array_equal(got.keys, idx)
    for name in ("weights", "buckets", "p_bucket", "bm_probe"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert len(set(want.buckets.tolist())) > 1


def test_trace_plan_from_reference_badness():
    key = jax.random.PRNGKey(8)
    streams = [draw_arrival_stream(k, CFG)
               for k in jax.random.split(jax.random.PRNGKey(9), 12)]
    want = RI.make_trace_ensemble_plan(key, CFG, GRID, streams,
                                       quotas=(3, 2, 2),
                                       edges_frac=(1.0, 1.3),
                                       runs_per_trace=2)
    n = len(streams)
    got = PI.trace_plan_from_badness(want.bm_trace, np.arange(n * 2), PCFG,
                                     quotas=(3, 2, 2), edges_frac=(1.0, 1.3),
                                     runs_per_trace=2)
    run_keys = np.asarray(jax.random.split(jax.random.split(key)[1], n * 2))
    idx = [int(np.nonzero((run_keys == k).all(axis=1))[0][0])
           for k in want.keys]
    np.testing.assert_array_equal(got.keys, idx)
    for name in ("trace_idx", "weights", "buckets", "p_bucket", "bm_trace"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_estimate_from_plan_matches_reference():
    _, plan = _probed()
    rng = np.random.default_rng(0)
    r = len(plan.weights)
    util = rng.uniform(0.3, 0.9, r).astype(np.float32)
    fails = rng.integers(0, 5, r).astype(np.float32)
    reqs = rng.integers(50, 500, r).astype(np.float32)
    want = RI.estimate_from_plan(plan, type("M", (), dict(
        utilization=util, failed_requests=fails, total_requests=reqs)))
    t = torch.from_numpy
    metrics = RunMetrics(*([t(util), None, t(reqs), t(fails)]
                           + [None] * 7))
    got = PI.estimate_from_plan(PI.ImportancePlan(*plan), metrics)
    assert got == want


class _Recording(PriorArrivalSource):
    def stream(self, gen, cfg):
        self.seen = super().stream(gen, cfg)
        return self.seen


def test_probe_stream_is_the_run_stream():
    """The probe of a seed draws the stream the run on that seed draws,
    and the port's BM and plan run end to end on the CPU."""
    src = _Recording()
    run = make_run(PCFG, np.asarray(GRID), SECOND, arrival_source=src,
                   device="cpu")
    run(123, make_policy(SECOND, rho=0.05, capacity=CFG.capacity))
    probe = PI._probe_streams([123], PCFG, torch.device("cpu"), None)
    for g, w in zip(jax.tree.leaves(bridge.to_numpy(probe)),
                    jax.tree.leaves(bridge.to_numpy(src.seen))):
        np.testing.assert_array_equal(g[0], w)
    bm = PI.badness_measure(123, PCFG, np.asarray(GRID), device="cpu")
    plan = PI.make_importance_plan(5, PCFG, np.asarray(GRID),
                                   quotas=(2, 2, 2), edges_frac=(1.0, 1.3),
                                   n_probe=24, probe_batch=10, device="cpu")
    assert bm == plan.bm_probe[0] or 123 not in plan.keys
    assert np.isfinite(bm) and bm > 0
    assert plan.bm_probe.shape == (24,)
    assert plan.weights.sum() == pytest.approx(
        plan.p_bucket[np.unique(plan.buckets)].sum())
    seeds = PI.split_seeds(5, 24)
    assert PI.badness_measure(seeds[3], PCFG, np.asarray(GRID),
                              device="cpu") == plan.bm_probe[3]
    m = PI.simulate_plan(run, plan, make_policy(SECOND, rho=0.05,
                                                capacity=CFG.capacity))
    est = PI.estimate_from_plan(plan, m)
    assert 0.0 < est["utilization"] <= 1.0
    assert est["n_runs"] == len(plan.keys)


def test_trace_plan_runs_on_the_cpu():
    from repro_torch.traces import TraceSpec, synthesize_scenario, \
        trace_to_stream

    spec = TraceSpec(horizon_hours=120 * 24.0, arrival_rate=0.2,
                     max_deployments=256, max_events=8,
                     priors=PCFG.priors)
    streams = [trace_to_stream(synthesize_scenario(s, "baseline", spec,
                                                   device="cpu"), PCFG)[0]
               for s in range(6)]
    plan = PI.make_trace_ensemble_plan(3, PCFG, np.asarray(GRID), streams,
                                       quotas=(2, 1, 1),
                                       edges_frac=(1.0, 1.3),
                                       runs_per_trace=2, probe_batch=4)
    assert plan.bm_trace.shape == (6,)
    for i, s in enumerate(streams[:2]):
        life = torch.Generator().manual_seed(
            PI.split_seeds(PI.split_seeds(3, 2)[0], 6)[i])
        assert PI.stream_badness(life, s, PCFG, np.asarray(GRID)) == \
            plan.bm_trace[i]
    run = make_run(PCFG, np.asarray(GRID), SECOND, device="cpu")
    m = PI.simulate_trace_plan(run, plan, streams,
                               make_policy(SECOND, rho=0.05,
                                           capacity=CFG.capacity))
    assert m.utilization.shape == (len(plan.keys),)
    # split over 2 logical devices (the mesh): the same metrics
    split = PI.simulate_trace_plan(run, plan, streams,
                                   make_policy(SECOND, rho=0.05,
                                               capacity=CFG.capacity),
                                   devices=["cpu", "cpu"])
    for x, y in zip(split, m):
        assert torch.equal(x, y)


def test_point_mass_factors_against_float64_oracle():
    """E[mu^nu] = exp(lgamma(a + nu) - lgamma(a) - nu log b) at the
    point-mass shapes a = mu 1e6 (mu from the Azure priors), in float32 by
    each package, against scipy in float64. Prints both errors; the port
    must be no worse than the JAX package (median and 90th percentile of
    the relative error)."""
    key = jax.random.PRNGKey(0)
    stream = draw_arrival_stream(key, CFG)
    params = jax.tree.map(lambda x: x.reshape(-1), stream.params)
    bel = RI._point_mass(params)
    c0 = stream.c0.reshape(-1)
    want = np.asarray(j_pack(bel, c0, CFG.priors).e_mu_nu, np.float64)
    got = p_pack(bridge.from_reference(_np(bel)), torch.from_numpy(
        np.asarray(c0)), PCFG.priors).e_mu_nu.numpy().astype(np.float64)
    a = np.asarray(bel.mu_a, np.float64)
    b = np.asarray(bel.mu_b, np.float64)
    nu = CFG.priors.nu
    oracle = np.exp(gammaln(a + nu) - gammaln(a) - nu * np.log(b))
    err_ref = np.abs(want - oracle) / oracle
    err_port = np.abs(got - oracle) / oracle
    q = lambda e: (float(np.median(e)), float(np.quantile(e, 0.9)))
    print(f"E[mu^nu] at k = 1e6, relative error against float64 "
          f"(median, p90): JAX package {q(err_ref)}, port {q(err_port)}")
    assert q(err_port)[0] <= q(err_ref)[0]
    assert q(err_port)[1] <= q(err_ref)[1]
