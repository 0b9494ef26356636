"""The port's trace subsystem against the JAX package's: schema IO in both
directions, ``validate_trace``'s refusals, the scenario registry, synthesis
(its deterministic pieces against the JAX package's, whole traces in law),
fitting on the JAX package's own trace, and replay.

Tolerances: integer fields, counts and decisions exact; float32
elementwise results 1e-6 relative; the float64 host fit 1e-12.

Replay streams are compared field for field. Under GLOBAL every field is
equal. Under the §6/§7 modes every field is equal but ``bel.lam_b`` (and
``bel_alt.lam_b``), which adds E[mu^nu] = exp(lgamma(a+nu) - lgamma(a) - nu
log b): the two packages' float32 log-gamma functions round differently,
so ``lam_b`` is held to ``tests/test_torch_priors.py``'s bound (rtol 2e-6
plus 4 float32 ulps of each term of the log), as every other fold of
pseudo observations in the port is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from repro.core import SECOND, geometric_grid, make_policy as j_make_policy
from repro.sim import (GLOBAL, MIX_LABELED, MIX_UNLABELED, PSEUDO,
                       make_config, make_run as j_make_run)
from repro.core.processes import (DeploymentParams as JParams,
                                  sample_params as j_sample_params,
                                  sample_pseudo_observations as j_sample_obs)
from repro import traces as RT
from repro.traces import synth as RS
from repro_torch import bridge
from repro_torch import traces as PT
from repro_torch.core import make_policy
from repro_torch.sim import make_run
from repro_torch.traces import synth as PS
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

SMALL_SPEC = RT.TraceSpec(horizon_hours=60 * 24.0, arrival_rate=0.3,
                          max_deployments=512, max_events=8)
P_SMALL_SPEC = PT.TraceSpec(*SMALL_SPEC[:4],
                            priors=bridge.from_reference(SMALL_SPEC.priors))
CFG = make_config(capacity=500.0, arrival_rate=0.08, horizon_hours=60 * 24.0,
                  dt=24.0, max_slots=128, max_arrivals=6, d_points=8)
GRID = geometric_grid(24.0, 3 * 60 * 24.0, 12)
RTOL = 1e-6
RTOL_FIT = 1e-12
RTOL_FOLD = 2e-6
ULPS_OF_ONE = 4 * 2.0**-23
KS_P = 1e-4     # a false alarm per comparison has probability 1e-4
MODES = {"global": (GLOBAL, 0), "pseudo": (PSEUDO, 5),
         "labeled": (MIX_LABELED, 5), "unlabeled": (MIX_UNLABELED, 5)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["baseline", "batched", "flash_crowd"])
def jax_trace(request):
    """The JAX package's trace of a scenario (numpy leaves)."""
    return _np(RT.synthesize_scenario(jax.random.PRNGKey(7), request.param, SMALL_SPEC))


@pytest.fixture(scope="module")
def flash_trace():
    return _np(RT.synthesize_scenario(jax.random.PRNGKey(7), "flash_crowd", SMALL_SPEC))


def _port(trace):
    return bridge.from_reference(trace)


def _assert_trace_equal(got, want):
    got = bridge.to_numpy(got)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(tuple(got)),
                            jax.tree.leaves(tuple(want))):
        np.testing.assert_array_equal(g, np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def test_npz_roundtrip_across_packages(jax_trace, tmp_path):
    p = str(tmp_path / "port.npz")
    PT.save_npz(_port(jax_trace), p)
    _assert_trace_equal(_port(_np(RT.load_npz(p))), jax_trace)
    q = str(tmp_path / "jax.npz")
    RT.save_npz(jax_trace, q)
    _assert_trace_equal(PT.load_npz(q, device="cpu"), jax_trace)


def test_csv_roundtrip_across_packages(jax_trace, tmp_path):
    p = str(tmp_path / "port.csv")
    PT.save_csv(_port(jax_trace), p)
    q = str(tmp_path / "jax.csv")
    RT.save_csv(jax_trace, q)
    for path in (p, q):
        assert open(path).read() == open(q).read()
        assert (open(PT.events_csv_path(path)).read()
                == open(RT.events_csv_path(q)).read())
    got = PT.load_csv(p, device="cpu")
    _assert_trace_equal(got, _np(RT.load_csv(p)))
    assert PT.n_deployments(got) == int(jax_trace.valid.sum())
    assert PT.has_latents(got) == RT.has_latents(jax_trace)


def _bad(trace, **cols):
    return trace._replace(**{k: torch.as_tensor(v) for k, v in cols.items()})


def test_validate_trace_refusals(jax_trace):
    tr = _port(jax_trace)
    t = tr.arrival_hours.numpy().copy()
    i = int(np.nonzero(tr.valid.numpy())[0][1])
    t[i - 1] = t[i] + 1.0
    with pytest.raises(ValueError, match="sorted"):
        PT.validate_trace(_bad(tr, arrival_hours=t))
    with pytest.raises(ValueError, match="outside"):
        PT.validate_trace(_bad(tr, arrival_hours=tr.arrival_hours + 1e5))
    with pytest.raises(ValueError, match="shape"):
        PT.validate_trace(_bad(tr, c0=tr.c0[:-1]))
    ev = tr.events._replace(cores=tr.events.cores[:, :-1])
    with pytest.raises(ValueError, match="disagree"):
        PT.validate_trace(tr._replace(events=ev))
    ev = PT.ScaleoutEvents(*(x[:-1] for x in tr.events))
    with pytest.raises(ValueError, match="leading dim"):
        PT.validate_trace(tr._replace(events=ev))
    assert PT.validate_trace(tr) is tr


def test_registry_matches_reference():
    assert PT.scenario_names() == RT.scenario_names()
    for name in PT.scenario_names():
        assert PT.get_scenario(name).describe == RT.get_scenario(name).describe
    with pytest.raises(KeyError, match="unknown scenario"):
        PT.get_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        PT.register_scenario("baseline")(lambda g, s: None)


def test_trace_presets_match_reference():
    from repro.configs import paper_cluster as RC
    from repro_torch.configs import TRACE_CPU, TRACE_FULL

    for got, want in ((TRACE_FULL, RC.TRACE_FULL), (TRACE_CPU, RC.TRACE_CPU)):
        assert tuple(got[:4]) == tuple(want[:4])
        assert tuple(got.priors) == tuple(want.priors)


def test_synthesis_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: synthesis runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PT.synthesize_scenario(0, "baseline", P_SMALL_SPEC)


# ---------------------------------------------------------------------------
# synthesis: the deterministic pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("uniform", [False, True])
def test_expected_exposure_frac_matches_reference(uniform):
    rng = np.random.default_rng(0)
    mu = np.exp(rng.uniform(-12, 3, 4096)).astype(np.float32)
    w = np.exp(rng.uniform(-9, 9, 4096)).astype(np.float32)
    want = RS._expected_exposure_frac(jnp.asarray(mu), jnp.asarray(w),
                                      uniform)
    got = PS._expected_exposure_frac(torch.from_numpy(mu),
                                     torch.from_numpy(w), uniform)
    assert (mu * w < 1e-6).any() and (mu * w > 1e-6).any()
    if not uniform:
        for g, x in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=RTOL)
        return
    # P = 1 - (1 - e^{-mu w}) / (mu w) cancels: the packages' expm1 differ
    # by float32 ulps, which the difference from 1 keeps as absolute ulps of
    # 1; the exposure is P / mu
    p, x = (np.asarray(a, np.float64) for a in want)
    assert np.abs(got[0].numpy() - p).max() <= ULPS_OF_ONE
    assert (np.abs(got[1].numpy() - x) * mu).max() <= ULPS_OF_ONE * 1.001


@pytest.mark.parametrize("scenario", ["diurnal", "flash_crowd"])
def test_time_warp_matches_jnp_interp(scenario):
    """``interp`` against ``jnp.interp`` on the scenario's own warp table
    (the JAX package's), clamping outside the table included; and the
    port's table against the JAX package's construction."""
    horizon = SMALL_SPEC.horizon_hours
    if scenario == "diurnal":
        j_prof = lambda t: 1.0 + RS._DIURNAL_DEPTH * jnp.sin(
            2.0 * np.pi * t / 24.0)
        p_prof = PS.diurnal_profile
    else:
        def j_prof(t):
            m = jnp.ones_like(t)
            for frac, dur in RS._FLASH_WINDOWS:
                start = frac * horizon
                m = jnp.where((t >= start) & (t < start + dur),
                              RS._FLASH_MULT, m)
            return m
        p_prof = PS.flash_profile(horizon)
    t_grid = jnp.linspace(0.0, horizon, RS._WARP_POINTS + 1)
    r_grid = jnp.maximum(j_prof(t_grid), 0.0)
    dt_g = horizon / RS._WARP_POINTS
    lam_grid = jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(
        0.5 * (r_grid[1:] + r_grid[:-1]) * dt_g)])
    p_lam, p_t = PS.warp_table(p_prof, horizon, "cpu")
    np.testing.assert_allclose(p_t.numpy(), np.asarray(t_grid), rtol=RTOL,
                               atol=1e-3)
    np.testing.assert_allclose(p_lam.numpy(), np.asarray(lam_grid),
                               rtol=RTOL, atol=1e-3)
    total = float(lam_grid[-1])
    rng = np.random.default_rng(1)
    m = np.concatenate([rng.uniform(0, total, 5000),
                        [-5.0, 0.0, total, total * 2.0],
                        np.asarray(lam_grid)[::97]]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(m), lam_grid, t_grid))
    got = PS.interp(torch.from_numpy(m), torch.from_numpy(
        np.asarray(lam_grid)), torch.from_numpy(np.asarray(t_grid))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
    assert got[-len(np.asarray(lam_grid)[::97]) - 4] == 0.0      # clamped
    assert got[-len(np.asarray(lam_grid)[::97]) - 1] == np.float32(horizon)


def test_drift_factors_match_reference():
    h = 240 * 24.0
    t = np.linspace(-10.0, h + 10.0, 3001).astype(np.float32)
    for fn in ("drift_mu_ramp", "drift_mu_step"):
        want = np.asarray(getattr(RS, fn)(jnp.asarray(t), h))
        got = getattr(PS, fn)(torch.from_numpy(t), h).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=fn)
    assert (PT.DRIFT_MU_SCALE, PT.DRIFT_RAMP_FRACS, PT.DRIFT_STEP_FRAC) == (
        RT.DRIFT_MU_SCALE, RT.DRIFT_RAMP_FRACS, RT.DRIFT_STEP_FRAC)
    got = PT.drifted_priors(bridge.from_reference(SMALL_SPEC.priors))
    assert tuple(got) == tuple(RT.drifted_priors(SMALL_SPEC.priors))


# ---------------------------------------------------------------------------
# synthesis: whole traces in law
# ---------------------------------------------------------------------------

N_TRACES = 24


def _columns(traces):
    """Per-trace arrival counts, and the valid rows' columns pooled."""
    cols = {"count": np.array([t.valid.sum() for t in traces], np.float64)}
    for name in ("arrival_hours", "c0", "obs_window", "n_scaleouts",
                 "core_hours"):
        cols[name] = np.concatenate([np.asarray(getattr(t, name))[t.valid]
                                     for t in traces]).astype(np.float64)
    return cols


@pytest.mark.parametrize("scenario", RT.scenario_names())
def test_scenarios_match_reference_in_law(scenario):
    keys = jax.random.split(jax.random.PRNGKey(11), N_TRACES)
    batch = _np(jax.vmap(lambda k: RT.synthesize_scenario(
        k, scenario, SMALL_SPEC))(keys))
    want = [jax.tree.map(lambda x: x[i], batch) for i in range(N_TRACES)]
    got = []
    for s in range(N_TRACES):
        tr = PT.synthesize_scenario(1000 + s, scenario, P_SMALL_SPEC,
                                    device="cpu")
        PT.validate_trace(tr)
        got.append(bridge.to_numpy(tr))
    wc, gc = _columns(want), _columns(got)
    for name in wc:
        p = ks_2samp(gc[name], wc[name]).pvalue
        assert p > KS_P, (scenario, name, p, gc[name].mean(),
                          wc[name].mean())


# ---------------------------------------------------------------------------
# fitting on the JAX package's trace
# ---------------------------------------------------------------------------

#: SMALL_SPEC's shapes (JAX's eager ops compiled once), 512 arrivals spread
#: over a year
FIT_SPEC = SMALL_SPEC._replace(horizon_hours=365 * 24.0)


@pytest.fixture(scope="module")
def fit_trace():
    return _np(RT.synthesize_scenario(jax.random.PRNGKey(0), "baseline", FIT_SPEC))


def _assert_stats_equal(got, want):
    for f in RT.FitStats._fields:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL_FIT, err_msg=f)


def test_window_and_merged_stats_match_reference(fit_trace):
    tr = _port(fit_trace)
    edges = [0.0, 2000.0, 5000.0, np.inf]
    got = [PT.window_stats(tr, a, b) for a, b in zip(edges[:-1], edges[1:])]
    want = [RT.window_stats(fit_trace, a, b)
            for a, b in zip(edges[:-1], edges[1:])]
    for g, w in zip(got, want):
        _assert_stats_equal(g, w)
    _assert_stats_equal(PT.merge_stats(*got), RT.merge_stats(*want))
    assert (PT.window_stats(tr).drift_channels()
            == RT.window_stats(fit_trace).drift_channels())
    assert PT.window_stats(tr).observables() == RT.window_stats(
        fit_trace).observables()


@pytest.mark.parametrize("source", ["latent", "observed"])
def test_fit_priors_matches_reference(fit_trace, source):
    got, gd = PT.fit_priors(_port(fit_trace), source=source)
    want, wd = RT.fit_priors(fit_trace, source=source)
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=RTOL_FIT)
    assert gd.keys() == wd.keys()
    assert gd["n_deployments"] == wd["n_deployments"]
    errs = PT.prior_relative_errors(got, bridge.from_reference(
        FIT_SPEC.priors))
    assert errs == pytest.approx(RT.prior_relative_errors(
        want, FIT_SPEC.priors), rel=1e-9)


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def _mode_cfg(mode):
    prior_mode, n_obs = MODES[mode]
    return CFG._replace(prior_mode=prior_mode, n_pseudo_obs=n_obs)


def _lam_b_rtol(bel, nu):
    a, b = (np.asarray(x, np.float64) for x in (bel.mu_a, bel.mu_b))
    from scipy.special import gammaln

    scale = (np.abs(gammaln(a + nu)) + np.abs(gammaln(a))
             + np.abs(nu * np.log(b)))
    return RTOL_FOLD + 4 * 2.0**-23 * scale


def _assert_stream_equal(got, want, nu):
    got = bridge.to_numpy(got)
    for part in ("params", "c0", "n_arrivals"):
        for g, w in zip(jax.tree.leaves(getattr(got, part)),
                        jax.tree.leaves(getattr(want, part))):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=part)
    for part in ("bel", "bel_alt"):
        g, w = getattr(got, part), getattr(want, part)
        for name in g._fields:
            gx, wx = getattr(g, name), np.asarray(getattr(w, name))
            if name != "lam_b":
                np.testing.assert_array_equal(gx, wx,
                                              err_msg=f"{part}.{name}")
                continue
            rel = np.abs(gx.astype(np.float64) - wx) / np.abs(wx)
            assert (rel <= _lam_b_rtol(g, nu)).all(), (part, rel.max())


@pytest.mark.parametrize("mode", ["global", "pseudo"])
def test_trace_to_stream_deterministic_modes_match_reference(jax_trace, mode):
    """GLOBAL and PSEUDO-observed: no draws, the same stream and drops."""
    cfg = _mode_cfg(mode)
    want, w_drop = RT.trace_to_stream(jax_trace, cfg,
                                      pseudo_source="observed")
    got, g_drop = PT.trace_to_stream(_port(jax_trace), port_config(cfg),
                                     pseudo_source="observed")
    assert int(g_drop) == int(w_drop)
    _assert_stream_equal(got, _np(want), cfg.priors.nu)


@pytest.mark.parametrize("mode", ["pseudo", "labeled", "unlabeled"])
def test_trace_to_stream_sampled_modes_on_reference_draws(jax_trace, mode):
    """PSEUDO-latent and the §7 modes with the JAX package's pseudo
    observations (and §7 alternative type) handed in."""
    cfg = _mode_cfg(mode)
    key = jax.random.PRNGKey(3)
    want, w_drop = RT.trace_to_stream(jax_trace, cfg, key=key,
                                      pseudo_source="latent")
    k_own, k_par, k_obs = jax.random.split(key, 3)
    own = j_sample_obs(k_own, JParams(lam=jnp.asarray(jax_trace.lam),
                                      mu=jnp.asarray(jax_trace.mu),
                                      sig=jnp.asarray(jax_trace.sig)),
                       cfg.priors, cfg.n_pseudo_obs)
    draws = PT.ReplayDraws(own=bridge.from_reference(_np(own)))
    if mode != "pseudo":
        alt = j_sample_params(k_par, cfg.priors,
                              (cfg.n_steps, cfg.max_arrivals))
        alt_obs = j_sample_obs(k_obs, alt, cfg.priors, cfg.n_pseudo_obs)
        draws = draws._replace(alt=bridge.from_reference(_np(alt)),
                               alt_obs=bridge.from_reference(_np(alt_obs)))
    got, g_drop = PT.trace_to_stream(_port(jax_trace), port_config(cfg),
                                     pseudo_source="latent", draws=draws)
    assert int(g_drop) == int(w_drop)
    _assert_stream_equal(got, _np(want), cfg.priors.nu)


def test_fleet_config_replays_one_fleet_wide_stream(jax_trace):
    from repro.sim import FleetConfig as JFleet

    fcfg = JFleet(base=CFG, capacities=(300.0, 200.0))
    want, w_drop = RT.trace_to_stream(jax_trace, fcfg)
    got, g_drop = PT.trace_to_stream(_port(jax_trace),
                                     bridge.from_reference(fcfg))
    assert int(g_drop) == int(w_drop)
    _assert_stream_equal(got, _np(want), CFG.priors.nu)


def test_replay_refusals(jax_trace):
    tr = _port(jax_trace)
    with pytest.raises(ValueError, match="generator"):
        PT.trace_to_stream(tr, port_config(_mode_cfg("pseudo")),
                           pseudo_source="latent")
    with pytest.raises(ValueError, match="generator"):
        PT.trace_to_stream(tr, port_config(_mode_cfg("labeled")),
                           pseudo_source="observed")
    with pytest.raises(ValueError, match="pseudo_source"):
        PT.TraceArrivalSource(tr, pseudo_source="nope")
    assert PT.TraceArrivalSource(tr).pseudo_source == "latent"
    nolat = tr._replace(lam=torch.full_like(tr.lam, float("nan")))
    assert PT.TraceArrivalSource(nolat).pseudo_source == "observed"


def test_params_from_trace_imputes_like_reference(jax_trace):
    """A trace without latents: the conjugate posterior means (float32
    elementwise, the power mu**nu rounded by each package's pow)."""
    nan = np.full_like(jax_trace.lam, np.nan)
    tr = jax_trace._replace(lam=nan, mu=nan, sig=nan)
    want = RT.params_from_trace(tr, CFG.priors)
    got = PT.params_from_trace(_port(tr), bridge.from_reference(CFG.priors))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_replayed_run_takes_reference_decisions(flash_trace):
    """``TraceArrivalSource`` through the port's ``make_run`` on the JAX
    package's event draws of the same replayed run: the same decisions and
    counts, utilization to rtol 1e-5."""
    src = RT.TraceArrivalSource(flash_trace)
    key = jax.random.PRNGKey(5)
    rho = 0.05
    want_m, want_acc = j_make_run(CFG, GRID, SECOND, arrival_source=src,
                                  record_decisions=True)(
        key, j_make_policy(SECOND, rho=rho, capacity=CFG.capacity))
    stream = src.stream(jax.random.split(key)[0], CFG)
    stream = jax.tree.map(lambda x: np.asarray(x)[None], stream)
    _, events = reference_draws(CFG, GRID, SECOND, [key], [rho],
                                stream=stream)
    events = [type(ev)(*(x[0] for x in ev)) for ev in events]
    run = make_run(port_config(CFG), np.asarray(GRID), SECOND,
                   arrival_source=PT.TraceArrivalSource(_port(flash_trace)),
                   record_decisions=True, device="cpu")
    got_m, got_acc = run(0, make_policy(SECOND, rho=rho,
                                        capacity=CFG.capacity),
                         events=[bridge.from_reference(ev) for ev in events])
    flips = np.argwhere(got_acc.numpy() != np.asarray(want_acc))
    assert flips.size == 0, f"decisions differ at (step, lane) {flips}"
    for name in ("total_requests", "failed_requests", "arrivals_accepted",
                 "arrivals_rejected", "slot_overflow", "n_departed"):
        assert float(getattr(got_m, name)) == float(getattr(want_m, name)), \
            name
    np.testing.assert_allclose(float(got_m.utilization),
                               float(want_m.utilization), rtol=1e-5)
    assert np.asarray(want_acc).sum() > 0


def test_replayed_batch_shares_its_stream(jax_trace):
    """A batch replaying one trace builds its stream once; each run equals
    the run alone bit for bit."""
    source = PT.TraceArrivalSource(_port(jax_trace))
    cfg = port_config(CFG)
    assert source.shares_stream(cfg)
    assert not source.shares_stream(port_config(_mode_cfg("labeled")))
    run = make_run(cfg, np.asarray(GRID), SECOND, arrival_source=source,
                   device="cpu")
    policy = make_policy(SECOND, rho=0.05, capacity=CFG.capacity)
    batch = run([4, 9, 4], policy)
    for r, seed in enumerate([4, 9, 4]):
        alone = run(seed, policy)
        for name in alone._fields:
            assert torch.equal(getattr(batch, name)[r],
                               getattr(alone, name)), (seed, name)
    assert source.n_dropped(cfg) == int(RT.trace_to_stream(jax_trace,
                                                           CFG)[1])
