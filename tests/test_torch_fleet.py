"""The port's routed multi-cluster fleet against the JAX package's.

* ``fleet_policy``, ``broadcast_policy``, ``make_fleet_config`` and the
  fleet policy's capacity check: leaves and errors equal to the JAX
  package's.
* Each router on the same ``RouteContext`` and the JAX package's random
  draws gives the JAX router's ``assign``; the port's own draws are
  checked in law (uniform; the power-of-two choices distinct).
* ``make_fleet_run`` fed the JAX package's draws (``tests/torch_lockstep.py``
  records the stream, each step's per-cluster events and the router's
  draws) makes the JAX package's decisions and routing for every router:
  ``accept [T, C, A]``, ``assign [T, A]`` and the counts equal, float
  metrics within rtol 1e-5 (``test_torch_sim.py``'s tolerance; the fleet
  reductions over C clusters may differ from ``jnp.sum`` by an ulp), and
  the rider's ``telemetry_summary`` (with ``per_cluster``) equal.
* On the port's own draws: a fleet of one equals ``make_run`` bit for bit,
  run r of a fleet batch equals the fleet run alone, and the counterparts
  of ``tests/test_fleet.py``'s invariants hold.
* Fleet calibration: ``tests/test_torch_fleet_calibrate.py``.
* ``paper_cascade`` against the JAX grid, and the aggregate's plain
  version at that grid against the JAX package's fused aggregate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, ZEROTH
from repro.core import fleet_policy as j_fleet_policy
from repro.core import geometric_grid as j_geometric_grid
from repro.core import make_policy as j_make_policy
from repro.core import paper_cascade as j_paper_cascade
from repro.core.moments import MomentCurves as JMomentCurves
from repro.sim import FleetConfig as JFleetConfig
from repro.sim import ROUTERS as J_ROUTERS
from repro.sim import RouteContext as JRouteContext
from repro.sim import broadcast_policy as j_broadcast_policy
from repro.sim import make_config as j_make_config
from repro.sim import make_fleet_config as j_make_fleet_config
from repro.sim import make_fleet_run as j_make_fleet_run
from repro.sim import stream_config as j_stream_config
from repro.obs import telemetry_summary as j_telemetry_summary
from repro_torch import bridge
from repro_torch.core import (MomentCurves, PolicyParams, admit_sequential,
                              fleet_policy, make_policy, paper_cascade)
from repro_torch.obs import telemetry_summary
from repro_torch.sim import (ROUTERS, FleetConfig, RouteContext,
                             broadcast_policy, fleet_generators,
                             fleet_sla_failure_rate, fleet_utilization,
                             make_config, make_fleet_config, make_fleet_run,
                             make_run, stream_config)
from torch_lockstep import (fleet_policies, port_config, port_fleet_config,
                            reference_fleet_draws, router_draws)

# tests/test_fleet.py's configuration, with a refresh every 3 steps (the
# golden configuration's K) and the rider on
CFG = j_make_config(capacity=500.0, arrival_rate=0.08,
                    horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                    max_arrivals=4, d_points=8, agg_refresh_steps=3,
                    telemetry=True)
GRID = j_geometric_grid(24.0, 3 * 30 * 24.0, 12)
PGRID = np.asarray(GRID)
CAPS2 = (300.0, 200.0)
CAPS3 = (250.0, 150.0, 100.0)
RTOL = 1e-5
COUNTS = ("total_requests", "failed_requests", "arrivals_accepted",
          "arrivals_rejected", "rejected_by_all", "slot_overflow",
          "n_departed", "alive_end", "fail_trace")
# a busier fleet for the parity runs: about 3 arrivals a step, so that the
# routers' choices matter and some arrivals are rejected
BUSY = CFG._replace(arrival_rate=0.12)
J_BUSY3 = JFleetConfig(base=BUSY, capacities=CAPS3)
P_BUSY3 = port_fleet_config(J_BUSY3)
PCFG = port_config(CFG)
P_FLEET2 = FleetConfig(base=PCFG, capacities=CAPS2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _first(tree):
    """Run 0 of a batch: the first entry of every leaf (NamedTuples and
    plain tuples of arrays; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [_first(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return tree[0]


# ---------------------------------------------------------------------------
# policies and configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind, kw", [
    (SECOND, dict(rho=0.112)), (ZEROTH, dict(threshold=8864.0)),
    (SECOND, dict(rho=0.3, threshold=100.0, marginal=True))])
def test_fleet_policy_leaves_equal(kind, kw):
    caps = (8000.0, 6000.0, 4000.0, 2000.0)
    want = j_fleet_policy(kind, capacities=caps, **kw)
    got = fleet_policy(kind, capacities=caps, **kw)
    for name, a, b in zip(got._fields, got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)
        assert _np(a).dtype == np.asarray(b).dtype, name


def test_fleet_policy_of_a_batch_of_thetas_is_each_thetas():
    thetas = np.asarray([0.01, 0.112, 0.5], np.float32)
    got = fleet_policy(SECOND, capacities=CAPS3, threshold=thetas,
                       rho=thetas)
    want = fleet_policies(SECOND, CAPS3, thetas)
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == (3, 3), name
        np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=name)


def test_broadcast_policy_equal_and_shape_checked():
    pol = make_policy(SECOND, rho=0.2, capacity=100.0)
    got = broadcast_policy(pol, 3)
    want = j_broadcast_policy(j_make_policy(SECOND, rho=0.2, capacity=100.0),
                              3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    fpol = fleet_policy(ZEROTH, capacities=(1.0, 2.0, 3.0))
    assert broadcast_policy(fpol, 3) == fpol
    for mod, f_pol in ((broadcast_policy, fpol),
                       (j_broadcast_policy,
                        j_fleet_policy(ZEROTH, capacities=(1.0, 2.0, 3.0)))):
        with pytest.raises(ValueError, match="per cluster"):
            mod(f_pol, 2)
    # a batch takes [R, C] leaves, one policy for each run
    batch = fleet_policy(SECOND, capacities=CAPS2, rho=torch.tensor(
        [0.1, 0.2, 0.3]))
    assert broadcast_policy(batch, 2, runs=3) == batch
    with pytest.raises(ValueError, match="per cluster"):
        broadcast_policy(batch, 2)


def test_make_fleet_config_and_stream_config():
    kw = dict(max_slots=64, dt=12.0, horizon_hours=240.0)
    got, want = make_fleet_config(CAPS3, **kw), j_make_fleet_config(CAPS3,
                                                                   **kw)
    # the port's SimConfig defaults to the kernel lanes (sim/core.py)
    lanes = dict(use_kernel=True, agg_backend="kernel")
    want_p = bridge.from_reference(want)
    assert got == want_p._replace(base=want_p.base._replace(**lanes))
    assert got.n_clusters == 3 and got.total_capacity == 500.0
    assert stream_config(got).capacity == pytest.approx(sum(CAPS3))
    assert stream_config(got).max_arrivals == got.base.max_arrivals
    assert stream_config(PCFG) is PCFG
    assert stream_config(got) == bridge.from_reference(
        j_stream_config(want))._replace(**lanes)


@pytest.mark.parametrize("caps, match", [((), "capacities"),
                                         ((100.0, -1.0), "positive"),
                                         ((100.0, float("nan")), "positive")])
def test_make_fleet_config_rejects_bad_capacities(caps, match):
    for make in (make_fleet_config, j_make_fleet_config):
        with pytest.raises(ValueError, match=match):
            make(caps)


def test_fleet_total_capacity_policy_fails_fast():
    """A scalar fleet-TOTAL capacity tiled per cluster would let every
    cluster admit against the whole fleet's budget: run() rejects it, with
    the JAX package's message."""
    run = make_fleet_run(P_FLEET2, PGRID, SECOND, device="cpu")
    bad = make_policy(SECOND, rho=0.5, capacity=sum(CAPS2))
    with pytest.raises(ValueError, match="FleetConfig.capacities") as got:
        run(0, bad)
    j_run = j_make_fleet_run(JFleetConfig(base=CFG, capacities=CAPS2), GRID,
                             SECOND)
    with pytest.raises(ValueError) as want:
        j_run(jax.random.PRNGKey(0),
              j_make_policy(SECOND, rho=0.5, capacity=sum(CAPS2)))
    assert str(got.value).split(":")[1:] == str(want.value).split(":")[1:]
    # a batch's [R, C] capacities are each checked against the fleet's
    with pytest.raises(ValueError, match="FleetConfig.capacities"):
        run([0, 1], fleet_policy(SECOND, capacities=(200.0, 300.0), rho=0.5))


# ---------------------------------------------------------------------------
# routers on one RouteContext
# ---------------------------------------------------------------------------

def _contexts(seed, n_c, n_a=6, n_n=5, kind=SECOND, batch=None):
    """(JAX RouteContext, port RouteContext) of random state."""
    rng = np.random.default_rng(seed)
    caps = rng.uniform(40.0, 100.0, n_c).astype(np.float32)
    lead = () if batch is None else (batch,)
    f32 = lambda x: np.asarray(x, np.float32)
    cand_el = f32(rng.uniform(0.0, 25.0, (*lead, n_a, n_n)))
    cand_vl = f32(rng.uniform(0.0, 40.0, (*lead, n_a, n_n)))
    agg_el = f32(rng.uniform(0.0, 40.0, (*lead, n_c, n_n)))
    agg_vl = f32(agg_el * rng.uniform(0.2, 1.0, agg_el.shape))
    util = f32(rng.uniform(0.0, 60.0, (*lead, n_c)))
    c0 = f32(1.0 + rng.poisson(5.0, (*lead, n_a)))
    valid = rng.random((*lead, n_a)) < 0.8
    rho = float(rng.uniform(0.1, 0.5))
    thr = float(rng.uniform(20.0, 80.0) * n_c)
    arrays = (cand_el, cand_vl, c0, valid, agg_el, agg_vl, util)
    j_pol = j_fleet_policy(kind, capacities=tuple(caps.tolist()),
                           threshold=thr, rho=rho)
    p_pol = fleet_policy(kind, capacities=tuple(caps.tolist()),
                         threshold=thr, rho=rho)

    def ctx(mod_ctx, curves, conv, pol):
        el, vl, c, v, ae, av, u = map(conv, arrays)
        return mod_ctx(cand=curves(el, vl), c0=c, valid=v, agg_el=ae,
                       agg_vl=av, util=u, capacities=conv(caps), policy=pol)

    return (ctx(JRouteContext, JMomentCurves, jnp.asarray, j_pol),
            ctx(RouteContext, MomentCurves, torch.from_numpy, p_pol))


@pytest.mark.parametrize("name", sorted(ROUTERS))
@pytest.mark.parametrize("n_c", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_router_assign_equals_jax_on_its_draws(name, n_c, seed):
    for kind in (SECOND, ZEROTH):
        j_ctx, p_ctx = _contexts(seed, n_c, kind=kind)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(J_ROUTERS[name]().route(key, j_ctx))
        draws = router_draws(name, key, n_c, p_ctx.c0.shape[-1])
        got = ROUTERS[name]().assign(p_ctx, draws)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_router_on_a_batch_routes_each_run_alone(name):
    _, p_ctx = _contexts(7, 3, batch=4)
    gens = [torch.Generator().manual_seed(s) for s in range(4)]
    got = ROUTERS[name]().route(gens, p_ctx)
    for r in range(4):
        alone = p_ctx._replace(
            cand=MomentCurves(*(x[r] for x in p_ctx.cand)), c0=p_ctx.c0[r],
            valid=p_ctx.valid[r], agg_el=p_ctx.agg_el[r],
            agg_vl=p_ctx.agg_vl[r], util=p_ctx.util[r])
        want = ROUTERS[name]().route(torch.Generator().manual_seed(r), alone)
        np.testing.assert_array_equal(got[r].numpy(), want.numpy())


def test_routers_of_tests_test_fleet():
    """The JAX package's router unit cases (tests/test_fleet.py), through
    the port's routers."""
    def ctx(agg_el, util, caps, policy, c0, valid):
        agg_el = torch.as_tensor(np.asarray(agg_el, np.float32))
        zeros = torch.zeros(len(c0), agg_el.shape[1])
        return RouteContext(
            cand=MomentCurves(zeros, zeros),
            c0=torch.tensor(c0, dtype=torch.float32),
            valid=torch.tensor(valid), agg_el=agg_el, agg_vl=agg_el * 0.0,
            util=torch.tensor(util, dtype=torch.float32),
            capacities=torch.tensor(caps, dtype=torch.float32),
            policy=policy)

    pol = broadcast_policy(make_policy(ZEROTH, threshold=90.0,
                                       capacity=100.0), 2)
    got = ROUTERS["least_utilized"]().assign(ctx(
        np.zeros((2, 2)), [10.0, 0.0], [100.0, 100.0], pol, [5.0] * 3,
        [True] * 3))
    np.testing.assert_array_equal(got.numpy(), [1, 1, 0])
    pol = broadcast_policy(make_policy(SECOND, rho=0.2, capacity=100.0), 2)
    agg = np.stack([np.full(4, 80.0), np.full(4, 5.0)])
    c = ctx(agg, [80.0, 5.0], [100.0, 100.0], pol, [1.0] * 256, [True] * 256)
    got = ROUTERS["power_of_two"]().route(torch.Generator().manual_seed(1), c)
    np.testing.assert_array_equal(got.numpy(), np.ones(256))
    pol1 = broadcast_policy(make_policy(SECOND, rho=0.2, capacity=100.0), 1)
    c = ctx(np.zeros((1, 4)), [0.0], [100.0], pol1, [1.0] * 8, [True] * 8)
    got = ROUTERS["power_of_two"]().route(torch.Generator().manual_seed(0), c)
    np.testing.assert_array_equal(got.numpy(), np.zeros(8))
    pol = fleet_policy(ZEROTH, capacities=[100.0, 100.0], threshold=60.0)
    cascade = ROUTERS["cascade"]()
    got = cascade.assign(ctx(np.zeros((2, 2)), [28.0, 0.0], [100.0, 100.0],
                             pol, [5.0, 40.0], [True, True]))
    np.testing.assert_array_equal(got.numpy(), [1, 2])
    got = cascade.assign(ctx(np.zeros((2, 2)), [0.0, 0.0], [100.0, 100.0],
                             pol, [20.0] * 3, [True] * 3))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 2])


@pytest.mark.parametrize("seed", range(6))
def test_cascade_routed_implies_admit_sequential_accepts(seed):
    """With the fold, a cascade-routed arrival is accepted by its target
    cluster's ``admit_sequential`` on the same pre-step aggregates, bit for
    bit the same running state."""
    _, ctx = _contexts(100 + seed, 3)
    assign = ROUTERS["cascade"]().assign(ctx).numpy()
    assert ((assign >= 0) & (assign <= 3)).all()
    valid = ctx.valid.numpy()
    for c in range(3):
        mask = torch.from_numpy((assign == c) & valid)
        pol_c = PolicyParams(*(x[c] for x in ctx.policy))
        res = admit_sequential(pol_c, ctx.agg_el[c], ctx.agg_vl[c],
                               ctx.util[c], ctx.cand, ctx.c0, mask)
        np.testing.assert_array_equal(res.accept.numpy(), mask.numpy())


@pytest.mark.parametrize("n_c", [2, 3, 5])
def test_router_draws_in_law(n_c):
    """The port's own draws: the random router's assignment uniform over the
    clusters (chi-square), power-of-two's first choice uniform, its second
    uniform over the others and never the first."""
    from scipy import stats

    _, ctx = _contexts(0, n_c, n_a=4000)
    gen = torch.Generator().manual_seed(n_c)
    picks = ROUTERS["random"]().draw(gen, ctx).numpy()
    counts = np.bincount(picks, minlength=n_c)
    assert stats.chisquare(counts).pvalue > 1e-3
    first, off = (x.numpy() for x in ROUTERS["power_of_two"]().draw(gen, ctx))
    second = (first + 1 + off) % n_c
    assert (first != second).all()
    assert stats.chisquare(np.bincount(first, minlength=n_c)).pvalue > 1e-3
    pairs = np.bincount(first * n_c + second, minlength=n_c * n_c)
    pairs = pairs.reshape(n_c, n_c)[~np.eye(n_c, dtype=bool)]
    assert stats.chisquare(pairs).pvalue > 1e-3


# ---------------------------------------------------------------------------
# make_fleet_run on the JAX package's draws
# ---------------------------------------------------------------------------

PARITY_CASES = {
    "least_utilized": (SECOND, 0.05),
    "power_of_two": (SECOND, 0.05),
    "random": (SECOND, 0.05),
    "cascade": (SECOND, 0.05),
    "cascade_zeroth": (ZEROTH, 120.0),
}


@pytest.fixture(scope="module", params=sorted(PARITY_CASES))
def fleet_parity(request):
    """(router name, JAX outputs, port outputs) of one fleet run (seed 1)
    on the JAX package's draws."""
    case = request.param
    name = case.split("_zeroth")[0]
    kind, theta = PARITY_CASES[case]
    key = jax.random.PRNGKey(1)
    j_pol = j_fleet_policy(kind, capacities=CAPS3, threshold=theta,
                           rho=theta)
    want = j_make_fleet_run(J_BUSY3, GRID, kind, router=J_ROUTERS[name](),
                            record_decisions=True)(key, j_pol)
    stream, events, draws = reference_fleet_draws(
        J_BUSY3, GRID, kind, key[None], fleet_policies(kind, CAPS3, [theta]),
        name)
    run = make_fleet_run(P_BUSY3, PGRID, kind, router=ROUTERS[name](),
                         record_decisions=True, device="cpu")
    got = run(0, fleet_policy(kind, capacities=CAPS3, threshold=theta,
                              rho=theta),
              stream=bridge.from_reference(_first(stream)),
              events=[bridge.from_reference(_first(ev)) for ev in events],
              route_draws=[_first(d) for d in draws])
    return case, want, got


def test_fleet_run_matches_jax_on_its_draws(fleet_parity):
    case, (j_m, j_acc, j_asg, j_tel), (t_m, t_acc, t_asg, t_tel) = \
        fleet_parity
    np.testing.assert_array_equal(t_asg.numpy(), np.asarray(j_asg))
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    j_acc = np.asarray(j_acc)
    assert j_acc.any() and (np.asarray(j_asg) >= 0).all()
    for name in j_m._fields:
        if name == "per_cluster":
            continue
        got, want = getattr(t_m, name).numpy(), np.asarray(getattr(j_m, name))
        if name in COUNTS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    for name in j_m.per_cluster._fields:
        got = getattr(t_m.per_cluster, name).numpy()
        want = np.asarray(getattr(j_m.per_cluster, name))
        if name in COUNTS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    assert telemetry_summary(t_tel) == j_telemetry_summary(j_tel)
    if case == "cascade_zeroth":
        assert float(t_m.rejected_by_all) > 0.0


# ---------------------------------------------------------------------------
# the port's own draws
# ---------------------------------------------------------------------------

def _assert_tree_equal(a, b, where=""):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            _assert_tree_equal(x, y, f"{where}{name}.")
        else:
            assert torch.equal(x, y), where + name


@pytest.mark.parametrize("kind, kw", [(SECOND, dict(rho=0.05)),
                                      (ZEROTH, dict(threshold=300.0))])
@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_fleet_of_one_is_make_run_bit_for_bit(kind, kw, telemetry):
    cfg = PCFG._replace(telemetry=telemetry)
    single = make_run(cfg, PGRID, kind, record_decisions=True, device="cpu")
    fleet = make_fleet_run(FleetConfig(base=cfg, capacities=(cfg.capacity,)),
                           PGRID, kind, record_decisions=True, device="cpu")
    for seed in (0, 3):
        want = single(seed, make_policy(kind, capacity=cfg.capacity, **kw))
        got = fleet(seed, fleet_policy(kind, capacities=(cfg.capacity,),
                                       **kw))
        m1, mf = want[0], got[0]
        for name in m1._fields:
            assert torch.equal(getattr(mf.per_cluster, name)[..., 0, :]
                               if getattr(m1, name).ndim else
                               getattr(mf.per_cluster, name)[0],
                               getattr(m1, name)), name
        assert torch.equal(mf.utilization, m1.utilization)
        assert float(mf.rejected_by_all) == 0.0
        assert torch.equal(got[1][:, 0], want[1])
        assert not got[2].any()
        if telemetry:
            _assert_tree_equal(type(got[3])(*(x[0] for x in got[3])),
                               want[2])


def test_fleet_generators_leave_the_run_generator_alone():
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    gens = fleet_generators(gen, 4)
    assert gens[0] is gen and len(gens) == 5
    assert torch.equal(gen.get_state(), state)
    draws = [torch.rand(4, generator=g) for g in gens[1:]]
    assert len({tuple(d.tolist()) for d in draws}) == 4
    again = fleet_generators(torch.Generator().manual_seed(11), 4)
    for g, d in zip(again[1:], draws):
        assert torch.equal(torch.rand(4, generator=g), d)


@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_fleet_batch_run_equals_run_alone(name):
    run = make_fleet_run(P_BUSY3, PGRID, SECOND, router=ROUTERS[name](),
                         record_decisions=True, device="cpu")
    seeds = [4, 9, 2]
    rhos = torch.tensor([0.05, 0.2, 0.5])
    batch = run(seeds, fleet_policy(SECOND, capacities=CAPS3, rho=rhos))
    for r, seed in enumerate(seeds):
        alone = run(seed, fleet_policy(SECOND, capacities=CAPS3,
                                       rho=float(rhos[r])))
        _assert_tree_equal(type(batch[0])(*(
            type(x)(*(y[r] for y in x)) if isinstance(x, tuple) else x[r]
            for x in batch[0])), alone[0])
        for got, want in zip(batch[1:], alone[1:]):
            if isinstance(want, tuple):
                _assert_tree_equal(type(got)(*(x[r] for x in got)), want)
            else:
                assert torch.equal(got[r], want)


@pytest.fixture(scope="module")
def fleet2_runs():
    """The SECOND two-cluster fleet (least utilized) on four seeds."""
    run = make_fleet_run(P_FLEET2, PGRID, SECOND, record_decisions=True,
                         device="cpu")
    pol = fleet_policy(SECOND, capacities=CAPS2, rho=0.5)
    return [run(seed, pol) for seed in (0, 17, 123, 999)]


def test_no_cluster_exceeds_its_capacity(fleet2_runs):
    for m, *_ in fleet2_runs:
        peaks = m.per_cluster.util_trace.numpy().max(axis=1)
        assert (peaks <= np.asarray(CAPS2) + 1e-3).all(), peaks


def test_alive_equals_admitted_minus_departed(fleet2_runs):
    for m, *_ in fleet2_runs:
        pc = m.per_cluster
        placed = pc.arrivals_accepted - pc.slot_overflow
        assert torch.equal(pc.alive_end, placed - pc.n_departed)


def test_fleet_metrics_reduce_per_cluster(fleet2_runs):
    for m, *_ in fleet2_runs:
        pc = m.per_cluster
        np.testing.assert_allclose(
            float(m.utilization),
            fleet_utilization(pc.utilization.numpy(), CAPS2), rtol=1e-6)
        assert float(m.failed_requests) == float(pc.failed_requests.sum())
        assert float(m.total_requests) == float(pc.total_requests.sum())
        assert float(m.failure_rate) == pytest.approx(fleet_sla_failure_rate(
            pc.failed_requests.numpy()[None], pc.total_requests.numpy()[None]))
        assert float(m.arrivals_rejected) == float(
            pc.arrivals_rejected.sum() + m.rejected_by_all)
        np.testing.assert_allclose(m.util_trace.numpy(),
                                   pc.util_trace.numpy().sum(axis=0),
                                   rtol=1e-6)


def test_routing_spreads_and_masks_decisions(fleet2_runs):
    for m, accept, assign, _ in fleet2_runs:
        a = assign.numpy()
        clusters = np.arange(2)[None, :, None]
        # an arrival is only ever decided by its target cluster
        assert not (accept.numpy() & (a[:, None, :] != clusters)).any()
    acc = sum(m.per_cluster.arrivals_accepted.numpy()
              for m, *_ in fleet2_runs)
    assert (acc > 0).all(), acc


def test_cascade_rejected_by_all_accounting_and_routed_admitted():
    fleet = FleetConfig(base=PCFG, capacities=CAPS2)
    run = make_fleet_run(fleet, PGRID, ZEROTH, router=ROUTERS["cascade"](),
                         record_decisions=True, device="cpu")
    m, accept, assign, _ = run(2, fleet_policy(ZEROTH, capacities=CAPS2,
                                               threshold=20.0))
    assert float(m.rejected_by_all) > 0.0
    pc = m.per_cluster
    assert float(m.arrivals_accepted) + float(m.arrivals_rejected) == float(
        pc.arrivals_accepted.sum() + pc.arrivals_rejected.sum()
        + m.rejected_by_all)
    # every cascade-routed arrival is admitted by its target cluster (the
    # cascade sends invalid lanes to the sentinel too)
    routed = assign.numpy()[:, None, :] == np.arange(2)[None, :, None]
    np.testing.assert_array_equal(accept.numpy(), routed)
    assert accept.numpy().sum() == float(m.arrivals_accepted)


# ---------------------------------------------------------------------------
# paper_cascade and the aggregate at its grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_per", [600, 100, 7])
def test_paper_cascade_equals_jax_grid(n_per):
    want = np.asarray(j_paper_cascade(n_per))
    got = paper_cascade(n_per).numpy()
    assert got.shape == want.shape
    assert (np.diff(got) > 0).all()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_aggregate_plain_version_at_paper_cascade_against_jax():
    """The aggregate kernel's plain version at ``paper_cascade``'s ~2,700
    points (the card runs it in chunks of 256) against the JAX package's
    fused aggregate, at the kernels' tolerances."""
    from repro.core import belief_from_prior
    from repro.core.moments import aggregate_moment_curves as j_aggregate
    from repro_torch.core import GammaBelief
    from repro_torch.kernels.moment_curves import kernel as PK
    from repro_torch.kernels.moment_curves.ops import curve_grid

    rng = np.random.default_rng(5)
    d, nd = 300, 24
    grid = np.asarray(j_paper_cascade())
    bel = belief_from_prior(AZURE_PRIORS, (d,))
    scale = lambda x: np.asarray(x) * np.exp(
        rng.normal(0.0, 0.5, d)).astype(np.float32)
    bel = type(bel)(*(scale(x) for x in bel))
    cores = (1.0 + rng.poisson(5.0, d)).astype(np.float32)
    alive = rng.random(d) < 0.6
    want = j_aggregate(jax.tree.map(jnp.asarray, bel), jnp.asarray(cores),
                       jnp.asarray(alive), jnp.asarray(grid), AZURE_PRIORS,
                       d_points=nd)
    t, idx, frac, _ = curve_grid(torch.from_numpy(np.array(grid)), nd)
    el, vl = PK.moment_curves_agg_belief(
        GammaBelief(*(torch.from_numpy(np.asarray(x, np.float32))
                      for x in bel)), torch.from_numpy(cores),
        torch.from_numpy(alive), t, idx, frac, nd,
        bridge.from_reference(AZURE_PRIORS))
    assert el.shape == (grid.shape[0],)
    np.testing.assert_allclose(el.numpy(), np.asarray(want.EL), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(vl.numpy(), np.asarray(want.VL), rtol=2e-3,
                               atol=1e-4)
    assert PK.agg_chunks(grid.shape[0])[-1][1] == grid.shape[0]
    assert all(b - a <= PK.AGG_MAX_N for a, b in PK.agg_chunks(2722))


def test_paper_cascade_through_make_run_and_make_fleet_run():
    """``paper_cascade``'s grid through both simulators on the CPU: finite
    metrics, and a fleet of one equal to ``make_run``."""
    cfg = PCFG._replace(horizon_hours=6 * 24.0, max_slots=32)
    grid = paper_cascade()
    want = make_run(cfg, grid, SECOND, record_decisions=True,
                    device="cpu")(5, make_policy(SECOND, rho=0.05,
                                                 capacity=cfg.capacity))
    got = make_fleet_run(FleetConfig(base=cfg, capacities=(cfg.capacity,)),
                         grid, SECOND, record_decisions=True,
                         device="cpu")(5, fleet_policy(
                             SECOND, capacities=(cfg.capacity,), rho=0.05))
    assert torch.equal(got[1][:, 0], want[1])
    assert torch.equal(got[0].per_cluster.utilization[0],
                       want[0].utilization)
    assert bool(torch.isfinite(want[0].utilization))


def test_fleet_bench_rows_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The router comparison benchmark end to end at a cut-down preset:
    one row a router, every router's calibrated numbers in the JSON."""
    import dataclasses
    import json

    from repro_torch.benchmarks import common, fleet_bench

    micro = dataclasses.replace(common.SCALES["tiny"], name="micro",
                                horizon_hours=48 * 12.0, max_slots=128,
                                n_runs=2, n_thresholds=2, grid_points=8)
    monkeypatch.setitem(common.SCALES, "micro", micro)
    out = tmp_path / "fleet.json"
    fleet_bench.main(["--scale", "micro", "--device", "cpu", "--json",
                      str(out)])
    rows = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in rows] == [
        f"scenarios/fleet/{name}" for name in fleet_bench.FLEET_ROUTERS]
    res = json.loads(out.read_text())["routers"]
    for name, r in res.items():
        assert 0.0 <= r["utilization"] <= 1.0, name
        assert len(r["cluster_utilization"]) == len(fleet_bench.FLEET_FRACS)
        assert r["rej_all"] >= 0.0
    assert res["least_utilized"]["rej_all"] == 0.0
