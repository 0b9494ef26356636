"""Batched runs of the port (a leading run axis written out), on the CPU.

* A batch equals its runs alone, bit for bit: every ``RunMetrics`` field
  and every decision, for mixed seeds (one repeated), kinds and thetas, at
  ``agg_refresh_steps`` 1 and 3.
* A batch fed the reference's own draws (``torch_lockstep``) matches the
  reference's ``make_run`` run by run: decisions, failed and total requests
  exactly, every other metric to rtol 1e-5 (``test_torch_sim.py``'s).
* The batched aggregate's plain version, and its emulation of the kernel's
  order of summation, equal the one-run forms run by run, and both agree
  with the JAX package's aggregate kernel in interpret mode under
  ``jax.vmap`` at its kernel tolerances (EL rtol 2e-4 / atol 1e-5, VL rtol
  2e-3 / atol 1e-4).
* The policies decide each run of a batch as they decide it alone;
  ``run_keyed_batch`` and ``run_batch`` take seeds, streams and devices as
  documented.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS
from repro.core import FIRST as R_FIRST
from repro.core import SECOND as R_SECOND
from repro.core import make_policy as r_make_policy
from repro.core.belief import GammaBelief as RGammaBelief
from repro.kernels.moment_curves import ops as ROPS
from repro.sim import make_run as r_make_run
from repro_torch import bridge
from repro_torch.core import (FIRST, SECOND, ZEROTH, admit_sequential,
                              decide_scored, is_safe, make_policy)
from repro_torch.core.belief import GammaBelief
from repro_torch.core.moments import MomentCurves
from repro_torch.kernels.moment_curves import kernel as K
from repro_torch.kernels.moment_curves import ops as POPS
from repro_torch.kernels.moment_curves import ref as PREF
from repro_torch.sim import (draw_arrival_stream, make_config, make_run,
                             run_batch, run_keyed_batch, split_seeds)
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

T_PRIORS = bridge.from_reference(AZURE_PRIORS)
TOL_EL = dict(rtol=2e-4, atol=1e-5)
TOL_VL = dict(rtol=2e-3, atol=1e-4)
RTOL_METRICS = 1e-5
# the SimCache configuration (tests/conftest.py): 30 steps, 96 slots
CFG = dict(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
           dt=24.0, max_slots=96, max_arrivals=4, d_points=8)
GRID = np.exp(np.linspace(np.log(24.0), np.log(3 * 30 * 24.0), 12)
              ).astype(np.float32)
# a batch: seeds (one repeated, under two policies), and for each make_run
# kind the policies of its five runs, (kind, theta) with theta both the
# threshold and rho
SEEDS = [3, 1, 4, 1, 5]
POLICIES = {
    ZEROTH: [(ZEROTH, t) for t in (300.0, 40.0, 200.0, 480.0, 120.0)],
    FIRST: [(FIRST, 300.0), (SECOND, 0.05), (FIRST, 120.0), (FIRST, 480.0),
            (SECOND, 0.2)],
    SECOND: [(SECOND, 0.05), (FIRST, 250.0), (SECOND, 0.01), (FIRST, 40.0),
             (SECOND, 0.3)],
}


def _policy(pairs, capacity):
    kinds, thetas = zip(*pairs)
    return make_policy(list(kinds), threshold=list(thetas), rho=list(thetas),
                       capacity=capacity)


@pytest.mark.parametrize("k_refresh", [1, 3])
@pytest.mark.parametrize("kind", [ZEROTH, FIRST, SECOND],
                         ids=["zeroth", "first", "second"])
def test_batch_equals_single_runs_bit_for_bit(kind, k_refresh):
    cfg = make_config(**CFG, agg_refresh_steps=k_refresh)
    run = make_run(cfg, GRID, kind, record_decisions=True, device="cpu")
    pairs = POLICIES[kind]
    metrics, accept = run(SEEDS, _policy(pairs, cfg.capacity))
    assert accept.shape == (len(SEEDS), cfg.n_steps, cfg.max_arrivals)
    assert metrics.util_trace.shape == (len(SEEDS), cfg.n_steps)
    for r, (seed, (one_kind, theta)) in enumerate(zip(SEEDS, pairs)):
        one, one_accept = run(seed, make_policy(
            one_kind, threshold=theta, rho=theta, capacity=cfg.capacity))
        assert torch.equal(accept[r], one_accept), r
        for name in one._fields:
            assert torch.equal(getattr(metrics, name)[r],
                               getattr(one, name)), (r, name)
    # the repeated seed under two policies: the same arrivals, other runs
    assert not torch.equal(metrics.util_trace[1], metrics.util_trace[3])
    assert bool(accept.any()) and bool((~accept).any())


# (kind, theta) of the parity batch's runs: each kind in a regime where it
# rejects and, for the tallest thetas, where scale-outs fail
PARITY = [(R_SECOND, 0.05), (R_SECOND, 0.5), (R_FIRST, 450.0),
          (R_FIRST, 525.0), (0, 420.0), (0, 500.0)]


def test_batch_with_reference_draws_matches_reference(sim_cache):
    """One port batch (6 keys x 6 policies), fed the reference's stream and
    events of each run, against the reference's make_run of each run."""
    cfg = sim_cache.cfg._replace(agg_refresh_steps=3)
    keys = np.asarray(sim_cache.keys)
    n_keys = len(keys)
    kinds = np.repeat([k for k, _ in PARITY], n_keys)
    thetas = np.repeat([t for _, t in PARITY], n_keys).astype(np.float32)
    keys_flat = np.tile(keys, (len(PARITY), 1))
    stream, events = reference_draws(cfg, sim_cache.grid, kinds, keys_flat,
                                     thetas)
    ref_run = r_make_run(cfg, sim_cache.grid, R_SECOND, record_decisions=True)
    want, want_accept = jax.jit(jax.vmap(lambda k, kind, th: ref_run(
        k, r_make_policy(kind, threshold=th, rho=th,
                         capacity=cfg.capacity))))(
        jnp.asarray(keys_flat), jnp.asarray(kinds), jnp.asarray(thetas))
    want = jax.tree.map(np.asarray, want)

    run = make_run(port_config(cfg), np.asarray(sim_cache.grid), SECOND,
                   record_decisions=True, device="cpu")
    policy = make_policy(torch.from_numpy(kinds), threshold=thetas,
                         rho=thetas, capacity=cfg.capacity)
    got, accept = run(list(range(len(kinds))), policy,
                      stream=bridge.from_reference(stream),
                      events=[bridge.from_reference(ev) for ev in events])
    np.testing.assert_array_equal(accept.numpy(), np.asarray(want_accept))
    for name in ("failed_requests", "total_requests", "arrivals_accepted",
                 "arrivals_rejected"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    for name, x in want._asdict().items():
        np.testing.assert_allclose(getattr(got, name).numpy(), x,
                                   rtol=RTOL_METRICS, err_msg=name)
    assert want.failed_requests.sum() > 0
    assert want.arrivals_rejected.sum() > 0


def _belief_runs(runs, d, n, seed):
    """numpy beliefs, cores and alive of ``runs`` x ``d`` slots, and a grid
    of ``n`` points."""
    rng = np.random.default_rng(seed)
    e = lambda base: (base * np.exp(rng.standard_normal((runs, d)))
                      ).astype(np.float32)
    bel = RGammaBelief(e(0.31), e(0.58), e(0.49), e(0.45), e(0.26), e(0.055))
    cores = (1.0 + rng.poisson(5.0, (runs, d))).astype(np.float32)
    alive = rng.random((runs, d)) < 0.6
    grid = np.exp(np.linspace(0.0, np.log(26_000.0), n)).astype(np.float32)
    return bel, cores, alive, grid


def _one(tree, r):
    return type(tree)(*(x[r] for x in tree))


CASES = [(runs, d, n) for runs in (1, 3) for d in (8, 300) for n in (12, 48)]


@pytest.mark.parametrize("runs,d,n", CASES)
def test_agg_runs_plain_version_is_the_one_run_version_per_run(runs, d, n):
    bel, cores, alive, grid = _belief_runs(runs, d, n, runs * 1000 + d + n)
    tbel = bridge.from_reference(bel)
    t_cores, t_alive = torch.from_numpy(cores), torch.from_numpy(alive)
    t, idx, frac, nd = POPS.curve_grid(torch.from_numpy(grid), 8)
    before = dict(K.LAUNCHES)
    el, vl = K.moment_curves_agg_belief(tbel, t_cores, t_alive, t, idx, frac,
                                        nd, T_PRIORS)
    entry = POPS.aggregate_moment_curves_kernel(
        tbel, t_cores, t_alive, torch.from_numpy(grid), T_PRIORS, d_points=8)
    assert K.LAUNCHES == before   # the plain version launches nothing
    assert el.shape == vl.shape == (runs, n)
    assert torch.equal(entry.EL, el) and torch.equal(entry.VL, vl)
    for r in range(runs):
        want_el, want_vl = PREF.moment_curves_agg_belief_ref(
            _one(tbel, r), t_cores[r], t_alive[r], t, idx, frac, nd,
            T_PRIORS)
        assert torch.equal(el[r], want_el) and torch.equal(vl[r], want_vl)


@pytest.mark.parametrize("runs,d,n", CASES)
def test_agg_runs_match_vmapped_jax_kernel(runs, d, n):
    """The batched plain version and the kernel-order emulation (on each
    run's grid of CTAs, as the kernel sizes it on a 132-SM card) against the
    JAX aggregate kernel vmapped over runs, in interpret mode."""
    bel, cores, alive, grid = _belief_runs(runs, d, n, runs * 7 + d * 3 + n)
    want = jax.vmap(lambda b, c, a: ROPS.aggregate_moment_curves_kernel(
        b, c, a, jnp.asarray(grid), AZURE_PRIORS, d_points=24,
        interpret=True))(RGammaBelief(*map(jnp.asarray, bel)),
                         jnp.asarray(cores), jnp.asarray(alive))
    tbel = bridge.from_reference(bel)
    t_cores, t_alive = torch.from_numpy(cores), torch.from_numpy(alive)
    t, idx, frac, nd = POPS.curve_grid(torch.from_numpy(grid), 24)
    plain = PREF.moment_curves_agg_belief_ref(tbel, t_cores, t_alive, t, idx,
                                              frac, nd, T_PRIORS)
    rows = [PREF.moment_curves_belief_ref(_one(tbel, r), t_cores[r], t, idx,
                                          frac, nd, T_PRIORS)
            for r in range(runs)]
    ctas = min(-(-d // PREF.AGG_ROWS_PER_CTA), 132)
    ordered = PREF.agg_in_kernel_order_runs(
        torch.stack([e for e, _ in rows]), torch.stack([v for _, v in rows]),
        t_alive.float(), ctas)
    for el, vl in (plain, ordered):
        np.testing.assert_allclose(el.numpy(), np.asarray(want.EL), **TOL_EL)
        np.testing.assert_allclose(vl.numpy(), np.asarray(want.VL), **TOL_VL)


@pytest.mark.parametrize("ctas", [1, 2, 5])
def test_agg_in_kernel_order_runs_is_the_one_run_form_per_run(ctas):
    bel, cores, alive, grid = _belief_runs(3, 300, 48, ctas)
    tbel = bridge.from_reference(bel)
    t_cores, t_alive = torch.from_numpy(cores), torch.from_numpy(alive)
    t, idx, frac, nd = POPS.curve_grid(torch.from_numpy(grid), 24)
    rows = [PREF.moment_curves_belief_ref(_one(tbel, r), t_cores[r], t, idx,
                                          frac, nd, T_PRIORS)
            for r in range(3)]
    el = torch.stack([e for e, _ in rows])
    vl = torch.stack([v for _, v in rows])
    got_el, got_vl = PREF.agg_in_kernel_order_runs(el, vl, t_alive.float(),
                                                   ctas)
    for r in range(3):
        want_el, want_vl = PREF.agg_in_kernel_order(el[r], vl[r],
                                                    t_alive[r].float(), ctas)
        assert torch.equal(got_el[r], want_el)
        assert torch.equal(got_vl[r], want_vl)


def _runs_inputs(shape=(2, 8)):
    bel = GammaBelief(*(torch.full(shape, 0.5) for _ in range(6)))
    t, idx, frac, nd = POPS.curve_grid(torch.from_numpy(GRID), 8)
    return bel, torch.ones(shape), torch.ones(shape, dtype=torch.bool), (
        t, idx, frac, nd)


@pytest.mark.parametrize("change, error", [
    (lambda b, c, a: (GammaBelief(*(x[None] for x in b)), c[None], a[None]),
     ValueError),                                       # [1, R, D]
    (lambda b, c, a: (b, c[:, :7].contiguous(), a), ValueError),
    (lambda b, c, a: (b, c, a[:, :7].contiguous()), ValueError),
    (lambda b, c, a: (b, c.t().contiguous().t(), a), ValueError),
    (lambda b, c, a: (b, c, a.float()), TypeError),
    (lambda b, c, a: (b, c[:0], a[:0]), ValueError),    # no runs
])
def test_agg_runs_launcher_refuses_bad_inputs(change, error):
    bel, cores, alive, grid = _runs_inputs()
    bel, cores, alive = change(bel, cores, alive)
    with pytest.raises(error):
        K.moment_curves_agg_belief(bel, cores, alive, *grid, T_PRIORS)


def test_policies_decide_each_run_as_alone():
    """admit_sequential, decide_scored and is_safe over a run axis: each
    run's decisions, diagnostics and updated aggregate equal those of the
    run alone, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    runs, a, n = 6, 4, 12
    agg_el = torch.rand(runs, n, generator=gen) * 400.0
    agg_vl = torch.rand(runs, n, generator=gen) * 900.0
    cand = MomentCurves(torch.rand(runs, a, n, generator=gen) * 40.0,
                        torch.rand(runs, a, n, generator=gen) * 90.0)
    c0 = torch.rand(runs, a, generator=gen) * 20.0
    util = torch.rand(runs, generator=gen) * 450.0
    valid = torch.rand(runs, a, generator=gen) < 0.8
    kinds = [ZEROTH, FIRST, SECOND, SECOND, FIRST, ZEROTH]
    thetas = [420.0, 430.0, 0.02, 0.3, 470.0, 300.0]
    policy = make_policy(kinds, threshold=thetas, rho=thetas, capacity=500.0,
                         marginal=True)
    res = admit_sequential(policy, agg_el, agg_vl, util, cand, c0, valid)
    ok, diag = decide_scored(policy, agg_el, agg_vl, util,
                             MomentCurves(cand.EL[:, 0], cand.VL[:, 0]),
                             c0[:, 0])
    safe = is_safe(policy, agg_el, agg_vl)
    for r in range(runs):
        one = make_policy(kinds[r], threshold=thetas[r], rho=thetas[r],
                          capacity=500.0, marginal=True)
        res1 = admit_sequential(one, agg_el[r], agg_vl[r], util[r],
                                MomentCurves(cand.EL[r], cand.VL[r]), c0[r],
                                valid[r])
        for got, want in zip(res, res1):
            assert torch.equal(got[r], want)
        ok1, diag1 = decide_scored(one, agg_el[r], agg_vl[r], util[r],
                                   MomentCurves(cand.EL[r, 0],
                                                cand.VL[r, 0]), c0[r, 0])
        assert torch.equal(ok[r], ok1)
        for got, want in zip(diag, diag1):
            assert torch.equal(got[r], want)
        assert torch.equal(safe[r], is_safe(one, agg_el[r], agg_vl[r]))
    assert bool(res.accept.any()) and bool((valid & ~res.accept).any())


@pytest.mark.parametrize("room", [0, 1, 2, 8])
def test_admit_room_folds_the_first_accepted_in_arrival_order(room):
    """``room`` (free slots) caps the returned aggregate at the first
    ``room`` accepted candidates, added one at a time in arrival order,
    alone and in a batch (bit for bit); decisions and util are those
    without it. Room 0-2 leaves accepted candidates without a slot."""
    gen = torch.Generator().manual_seed(room)
    runs, a, n = 5, 6, 12
    agg_el = torch.rand(runs, n, generator=gen) * 100.0
    agg_vl = torch.rand(runs, n, generator=gen) * 300.0
    cand = MomentCurves(torch.rand(runs, a, n, generator=gen) * 40.0,
                        torch.rand(runs, a, n, generator=gen) * 90.0)
    c0 = torch.rand(runs, a, generator=gen) * 20.0
    util = torch.rand(runs, generator=gen) * 100.0
    valid = torch.rand(runs, a, generator=gen) < 0.9
    policy = make_policy(SECOND, rho=0.3, capacity=500.0)
    free = torch.full((runs,), room)
    full = admit_sequential(policy, agg_el, agg_vl, util, cand, c0, valid)
    capped = admit_sequential(policy, agg_el, agg_vl, util, cand, c0, valid,
                              room=free)
    assert torch.equal(capped.accept, full.accept)
    assert torch.equal(capped.util, full.util)
    for r in range(runs):
        want_el, want_vl = agg_el[r], agg_vl[r]
        for i in torch.nonzero(full.accept[r]).flatten()[:room].tolist():
            want_el = want_el + cand.EL[r, i]
            want_vl = want_vl + cand.VL[r, i]
        alone = admit_sequential(policy, agg_el[r], agg_vl[r], util[r],
                                 MomentCurves(cand.EL[r], cand.VL[r]), c0[r],
                                 valid[r], room=free[r])
        for got in (capped, alone):
            el, vl = (got.agg_el, got.agg_vl) if got is alone else (
                got.agg_el[r], got.agg_vl[r])
            assert torch.equal(el, want_el) and torch.equal(vl, want_vl)
    assert int(full.accept.sum(-1).max()) > min(room, 2)


def test_processes_and_beliefs_broadcast_over_runs():
    """``sample_step_events`` with one generator a run, ``update_on_events``
    and ``observe_initial_size`` on [R, S] leaves: each run's row as the
    row alone (the draws from a copy of its generator)."""
    from repro_torch.core import (belief_from_prior, observe_initial_size,
                                  sample_params, sample_step_events,
                                  update_on_events)

    runs, slots = 3, 50
    gen = torch.Generator().manual_seed(4)
    params = sample_params(gen, T_PRIORS, (runs, slots))
    cores = 1.0 + torch.poisson(torch.full((runs, slots), 3.0), generator=gen)
    alive = torch.rand(runs, slots, generator=gen) < 0.7
    seeds = [11, 12, 11]
    ev = sample_step_events([torch.Generator().manual_seed(s) for s in seeds],
                            params, cores, T_PRIORS, 24.0, alive=alive)
    bel = observe_initial_size(belief_from_prior(T_PRIORS, (runs, slots)),
                               cores)
    upd = update_on_events(
        bel, core_deaths=ev.core_deaths, exposure_core_hours=cores * 24.0,
        n_scaleouts=ev.n_scaleouts, scaleout_cores=ev.scaleout_cores,
        alive_hours=24.0 * alive.float(), priors=T_PRIORS)
    for r, seed in enumerate(seeds):
        one = sample_step_events(torch.Generator().manual_seed(seed),
                                 _one(params, r), cores[r], T_PRIORS, 24.0,
                                 alive=alive[r])
        for got, want in zip(ev, one):
            assert torch.equal(got[r], want)
        bel1 = observe_initial_size(belief_from_prior(T_PRIORS, (slots,)),
                                    cores[r])
        upd1 = update_on_events(
            bel1, core_deaths=one.core_deaths,
            exposure_core_hours=cores[r] * 24.0,
            n_scaleouts=one.n_scaleouts, scaleout_cores=one.scaleout_cores,
            alive_hours=24.0 * alive[r].float(), priors=T_PRIORS)
        for got, want in zip(upd, upd1):
            assert torch.equal(got[r], want)
    assert bool(ev.n_scaleouts.any())


def _small_run(kind=SECOND):
    cfg = make_config(**CFG, agg_refresh_steps=3)
    return cfg, make_run(cfg, GRID, kind, device="cpu")


def test_split_seeds_is_deterministic_and_a_prefix():
    seeds = split_seeds(9, 5)
    assert seeds == split_seeds(9, 5) == split_seeds(9, 8)[:5]
    assert len(set(seeds)) == 5 and all(0 <= s < 2**63 for s in seeds)
    assert split_seeds(10, 5) != seeds


def test_run_batch_and_run_keyed_batch():
    cfg, run = _small_run()
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    batch = run_batch(run, 9, policy, 3)
    keyed = run_keyed_batch(run, split_seeds(9, 3), policy)
    for x, y in zip(batch, keyed):
        assert torch.equal(x, y)
    # a stacked [R] stream batch ([R, T, A] leaves): run r as the run alone
    # given stream r
    seeds = [11, 12, 13]
    streams = [draw_arrival_stream(torch.Generator().manual_seed(s), cfg)
               for s in (21, 22, 23)]
    stacked = type(streams[0])(*(
        type(x)(*(torch.stack(ys) for ys in zip(*xs)))
        if isinstance(x, tuple) else torch.stack(xs)
        for x, xs in zip(streams[0], zip(*streams))))
    got = run_keyed_batch(run, seeds, policy, streams=stacked)
    for r, (seed, stream) in enumerate(zip(seeds, streams)):
        for x, y in zip(got, run(seed, policy, stream=stream)):
            assert torch.equal(x[r], y)


def test_batch_over_more_than_one_device_raises():
    """A batch splits over devices (the mesh, ``tests/test_torch_mesh.py``):
    over two logical CPU devices it equals one batch; devices the host does
    not have raise, as every entry point on the card raises without one."""
    cfg, run = _small_run()
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    for x, y in zip(run_keyed_batch(run, [1, 2, 3], policy,
                                    devices=["cpu", "cpu"]),
                    run([1, 2, 3], policy)):
        assert torch.equal(x, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_batch(run, 0, policy, 2, devices=["cuda:0", "cuda:1"])
