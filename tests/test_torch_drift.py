"""The port's drift-aware recalibration against the JAX package's.

* Channels: ``channels_from_stats`` / ``channels_from_obs`` and
  ``window_channel_values`` on the JAX package's own traces equal the JAX
  package's (the same float64 host arithmetic on the same float32 columns).
* The detector: the CUSUM's sequence of (stat, fired) on the same channel
  values, the null calibrated from the JAX package's stationary replays'
  channel values (``null_from_replays`` against
  ``calibrate_drift_detector``), and ``warm_theta_bounds``, all equal.
* On the port's own draws: the false-alarm bound, step detection within
  ``tests/test_drift.py``'s delay window (seeds 3 and 42, as there), and
  ``run_drift_protocol`` at that file's tiny spec meeting its criteria.
* The engine: ``drift_detector=`` exports the JAX engine's ``"drift"``
  state for the same observable deltas (both engines fed the same events
  and tickets), and the ``drift_*`` Prometheus gauges.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import FIRST, SECOND, ZEROTH, geometric_grid
from repro.core import make_policy as j_make_policy
from repro.serve import Arrival as JArrival
from repro.serve import ExternalEvents as JExternalEvents
from repro.serve import OnlineAdmissionEngine as JEngine
from repro.sim import make_config
from repro import traces as RT
from repro import tuning as RU
from repro_torch import bridge
from repro_torch import traces as PT
from repro_torch import tuning as PU
from repro_torch.core import make_policy
from repro_torch.obs import snapshot_to_prometheus
from repro_torch.serve import Arrival, ExternalEvents, OnlineAdmissionEngine
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

SPEC = RT.TraceSpec(horizon_hours=240 * 24.0, arrival_rate=0.12,
                    max_deployments=2048, max_events=8)
PSPEC = None
WINDOW = 20 * 24.0
ONSET_W = 6
ALPHA = 0.1
N_REPS = 8
N_JAX_REPS = 4   # the JAX package's null replays (each an eager synthesis)


def _pspec():
    from repro_torch.configs import PAPER_CPU

    return PT.TraceSpec(*SPEC[:4], priors=PAPER_CPU.priors)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same(a, b):
    """Dicts of floats equal, NaN equal to NaN."""
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] == b[k]) or (np.isnan(a[k]) and np.isnan(b[k])), k


@pytest.fixture(scope="module")
def jax_reps():
    """The JAX package's null replays (``calibrate_drift_detector``'s
    traces, one per split key) and its null."""
    key = jax.random.PRNGKey(7)
    traces = [_np(RT.synthesize_scenario(k, "baseline", SPEC))
              for k in jax.random.split(key, N_JAX_REPS)]
    null = RU.calibrate_drift_detector(key, SPEC, window_hours=WINDOW,
                                       n_reps=N_JAX_REPS, alpha=ALPHA)
    return traces, null


def test_channels_match_reference(jax_reps):
    traces, _ = jax_reps
    for tr in traces[:3]:
        got = PU.window_channel_values(bridge.from_reference(tr), WINDOW)
        want = RU.window_channel_values(tr, WINDOW)
        assert len(got) == len(want) == 12
        for g, w in zip(got, want):
            _same(g, w)
        _same(PU.channels_from_stats(PT.window_stats(
                  bridge.from_reference(tr), 0.0, 3000.0)),
              RU.channels_from_stats(RT.window_stats(tr, 0.0, 3000.0)))
    obs = {"core_deaths": 12.0, "exposure_core_hours": 640.0,
           "n_scaleouts": 5.0, "alive_hours": 300.0, "scaleout_cores": 19.0}
    for o in (obs, {}, dict(obs, n_scaleouts=0.0)):
        _same(PU.channels_from_obs(o), RU.channels_from_obs(o))


def test_null_and_cusum_match_reference(jax_reps):
    traces, want = jax_reps
    reps = [RU.window_channel_values(tr, WINDOW) for tr in traces]
    got = PU.null_from_replays(reps, alpha=ALPHA)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    j_det, p_det = RU.DriftDetector(want), PU.DriftDetector(got)
    drifted = RU.window_channel_values(_np(RT.synthesize_scenario(
        jax.random.PRNGKey(3), "drift_step", SPEC)), WINDOW)
    for v in reps[0] + drifted + [{"mu": float("nan")}]:
        g, w = p_det.update(v), j_det.update(v)
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert p_det.snapshot() == j_det.snapshot()
    assert p_det.fired
    g = PU.detect_drift(bridge.from_reference(traces[1]), got,
                        window_hours=WINDOW)
    w = RU.detect_drift(traces[1], want, window_hours=WINDOW)
    assert (g.fired, g.fired_window, g.n_windows) == (
        w.fired, w.fired_window, w.n_windows)
    np.testing.assert_array_equal(g.stats, w.stats)


@pytest.mark.parametrize("kind", [ZEROTH, FIRST, SECOND])
def test_warm_theta_bounds_match_reference(kind):
    for theta0, frac in ((0.5 * 800.0, 0.25), (0.03, 0.1), (790.0, 0.4),
                         (2e-4, 0.25)):
        if kind != SECOND and theta0 < 1.0:
            continue
        assert PU.warm_theta_bounds(kind, theta0, 800.0, frac=frac) == \
            RU.warm_theta_bounds(kind, theta0, 800.0, frac=frac)


# ---------------------------------------------------------------------------
# on the port's own draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_null():
    return PU.calibrate_drift_detector(7, _pspec(), window_hours=WINDOW,
                                       n_reps=N_REPS, alpha=ALPHA,
                                       device="cpu")


def test_false_alarm_rate_bounded(port_null):
    n = 12
    fired = sum(int(PU.detect_drift(
        PT.synthesize_scenario(s, "baseline", _pspec(), device="cpu"),
        port_null, window_hours=WINDOW).fired) for s in range(100, 100 + n))
    bound = ALPHA + 3.0 * np.sqrt(ALPHA * (1 - ALPHA) / n)
    assert fired / n <= bound, (fired, n)
    assert port_null.n_windows == 12 and np.isfinite(port_null.threshold)


@pytest.mark.parametrize("seed", [3, 42])
def test_step_change_detected_with_bounded_delay(port_null, seed):
    tr = PT.synthesize_scenario(seed, "drift_step", _pspec(), device="cpu")
    rep = PU.detect_drift(tr, port_null, window_hours=WINDOW)
    assert rep.fired
    assert ONSET_W <= rep.fired_window <= ONSET_W + 3, rep.fired_window
    assert rep.stats[-1] >= rep.stats[rep.fired_window]


def test_ramp_detected(port_null):
    tr = PT.synthesize_scenario(5, "drift_ramp", _pspec(), device="cpu")
    assert PU.detect_drift(tr, port_null, window_hours=WINDOW).fired


def test_drift_protocol_meets_reference_criteria():
    """``tests/test_drift.py``'s regret protocol test, at its spec and
    config, on the port's draws."""
    from repro_torch.sim import make_config as p_make_config
    from repro_torch.sim import make_run
    from repro_torch.traces import drifted_priors

    cfg = p_make_config(capacity=800.0, arrival_rate=0.05,
                        horizon_hours=60 * 24.0, dt=24.0, max_slots=128,
                        max_arrivals=5, agg_refresh_steps=1)
    grid = np.asarray(geometric_grid(cfg.dt, cfg.horizon_hours * 3.0, 16))
    res = PU.run_drift_protocol(
        0, kind=SECOND, cfg=cfg, grid=grid, spec=_pspec(), tau=5e-3,
        window_hours=WINDOW, n_runs=4, n_grid=5, n_null_reps=6,
        device="cpu")
    assert res.report.fired
    assert res.delay_windows >= 0
    assert 0.0 <= res.delay_frac <= 1.0
    assert drifted_priors(cfg.priors).mu_rate == pytest.approx(
        cfg.priors.mu_rate / PT.DRIFT_MU_SCALE)
    assert res.triggered.regret <= res.never.regret + 1e-9
    assert res.within_ci
    assert res.triggered.n_sims <= res.oracle.n_sims
    # the warm re-tune's flat batches split over devices (the mesh): the
    # same result over 3 logical devices as over one
    run = make_run(cfg, grid, SECOND, device="cpu")
    keys = [0, 1, 2, 3]
    warm = [PU.retune_warm(run, SECOND, keys, capacity=800.0, tau=5e-3,
                           theta0=0.1, n_grid=3, max_stages=1,
                           devices=devices)
            for devices in (["cpu"], ["cpu"] * 3)]
    assert warm[0].theta == warm[1].theta
    for a, b in zip(warm[0].stages, warm[1].stages):
        np.testing.assert_array_equal(a.agg_fail, b.agg_fail)
        np.testing.assert_array_equal(a.util, b.util)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

CFG = make_config(capacity=300.0, arrival_rate=0.1, horizon_hours=12 * 24.0,
                  dt=24.0, max_slots=64, max_arrivals=4, d_points=8,
                  telemetry=True)
GRID = geometric_grid(CFG.dt, CFG.horizon_hours * 3, 12)
NULL = dict(mean={"mu": 0.004, "scaleout": 0.02, "size": 4.0},
            std={"mu": 0.002, "scaleout": 0.01, "size": 1.0},
            threshold=5.0, alpha=0.1, slack=0.5, n_reps=0, n_windows=0)


def test_engine_exports_the_reference_drift_state():
    rho = 0.3
    stream, events = reference_draws(CFG, GRID, SECOND,
                                     [jax.random.PRNGKey(2)], [rho])
    j_eng = JEngine(CFG, GRID, SECOND, j_make_policy(
        SECOND, rho=rho, capacity=CFG.capacity),
        drift_detector=RU.DriftDetector(RU.DriftNull(**NULL)))
    p_eng = OnlineAdmissionEngine(
        port_config(CFG), np.asarray(GRID), SECOND,
        make_policy(SECOND, rho=rho, capacity=CFG.capacity),
        drift_detector=PU.DriftDetector(PU.DriftNull(**NULL)), device="cpu")
    snaps = {}
    for name, eng, arrival, ext in (("jax", j_eng, JArrival, JExternalEvents),
                                    ("port", p_eng, Arrival, ExternalEvents)):
        snaps[name] = []
        for t, ev in enumerate(events):
            eng.tick(events=ext(*(x[0] for x in ev)))
            n = int(stream.n_arrivals[0, t])
            futs = [eng.submit(arrival.from_stream(
                jax.tree.map(lambda x: x[0], stream), t, a))
                for a in range(n)]
            eng.flush()
            [f.result(timeout=60.0) for f in futs]
            if t % 3 == 2:
                snaps[name].append(eng.metrics_snapshot())
    for g, w in zip(snaps["port"], snaps["jax"]):
        assert g["telemetry"]["obs"] == pytest.approx(w["telemetry"]["obs"],
                                                      rel=1e-6)
        gd, wd = g["drift"], w["drift"]
        assert gd.keys() == wd.keys()
        assert gd["channel_stats"] == pytest.approx(wd["channel_stats"],
                                                    rel=1e-5, abs=1e-9)
        assert gd["stat"] == pytest.approx(wd["stat"], rel=1e-5, abs=1e-9)
        for k in ("threshold", "fired", "fired_window", "n_windows"):
            assert gd[k] == wd[k], k
    assert snaps["port"][-1]["drift"]["n_windows"] == 4
    text = snapshot_to_prometheus(snaps["port"][-1])
    assert "repro_admission_drift_windows 4" in text
    assert 'repro_admission_drift_channel_stat{channel="mu"}' in text
    with pytest.raises(ValueError, match="telemetry"):
        OnlineAdmissionEngine(port_config(CFG._replace(telemetry=False)),
                              np.asarray(GRID), SECOND,
                              make_policy(SECOND, rho=rho,
                                          capacity=CFG.capacity),
                              drift_detector=PU.DriftDetector(
                                  PU.DriftNull(**NULL)), device="cpu")
