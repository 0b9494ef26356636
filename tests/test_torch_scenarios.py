"""The port's per-scenario re-tuning against the JAX package's, on the same
replay streams and draws: ``calibrate_scenario`` over the JAX package's
``replay_stream_batch`` streams, the port's run fed the JAX package's event
draws for every (run, theta) it asks for (``torch_lockstep.InjectedRuns``
with ``streams``). The stationary point's SLA rate and the re-tuned theta,
feasibility, simulations and stages are equal; utilizations to rtol 1e-5
(``test_torch_calibrate_parity.py``'s). Then the port's own
``replay_stream_batch`` end to end on the CPU."""
import jax
import numpy as np
import pytest

from repro.core import FIRST, SECOND, ZEROTH, geometric_grid
from repro.sim import make_config, make_run as j_make_run
from repro.traces import TraceSpec
from repro.tuning import calibrate_scenario as j_calibrate_scenario
from repro.tuning import replay_stream_batch as j_replay_stream_batch
from repro_torch import bridge
from repro_torch.sim import make_run
from repro_torch.tuning import calibrate_scenario, replay_stream_batch
from torch_lockstep import InjectedRuns, port_config
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

SPEC = TraceSpec(horizon_hours=60 * 24.0, arrival_rate=0.3,
                 max_deployments=512, max_events=8)
CFG = make_config(capacity=250.0, arrival_rate=0.3, horizon_hours=60 * 24.0,
                  dt=24.0, max_slots=128, max_arrivals=16, d_points=8)
GRID = geometric_grid(24.0, 3 * 60 * 24.0, 12)
N_RUNS = 2
TAU = 2e-3
STATIONARY = {ZEROTH: 0.44 * CFG.capacity, SECOND: 0.112}
RTOL_METRICS = 1e-5


@pytest.mark.parametrize("scenario, kind",
                         [("flash_crowd", ZEROTH), ("heavy_tail", SECOND)],
                         ids=["flash_crowd-zeroth", "heavy_tail-second"])
def test_calibrate_scenario_matches_reference(scenario, kind):
    streams, run_keys, dropped = j_replay_stream_batch(
        jax.random.PRNGKey(100), jax.random.PRNGKey(500), scenario, SPEC,
        CFG, N_RUNS)
    streams = jax.tree.map(np.asarray, streams)
    kw = dict(capacity=CFG.capacity, tau=TAU,
              stationary_theta=STATIONARY[kind], n_grid=4, max_stages=1)
    want = j_calibrate_scenario(j_make_run(CFG, GRID, kind), kind, scenario,
                                streams, run_keys, **kw)
    injected = InjectedRuns(CFG, GRID, run_keys, kind, streams=streams)
    got = calibrate_scenario(injected, kind, scenario,
                             bridge.from_reference(streams), range(N_RUNS),
                             **kw)
    assert got.stationary_sla == pytest.approx(want.stationary_sla,
                                               rel=1e-12, abs=1e-15)
    assert got.stationary_util == pytest.approx(want.stationary_util,
                                                rel=RTOL_METRICS)
    g, w = got.retuned, want.retuned
    assert (g.theta, g.feasible, g.n_sims) == (w.theta, w.feasible, w.n_sims)
    for gs, ws in zip(g.stages, w.stages):
        np.testing.assert_array_equal(gs.thetas, ws.thetas)
        np.testing.assert_array_equal(gs.agg_fail, ws.agg_fail)
        np.testing.assert_allclose(gs.util, ws.util, rtol=RTOL_METRICS)
    assert got.util_gap == pytest.approx(want.util_gap, abs=1e-5)
    assert w.stages[0].agg_fail.max() > 0


def test_replay_stream_batch_runs_on_the_cpu():
    from repro_torch.traces import TraceSpec as PSpec

    pcfg = port_config(CFG)
    spec = PSpec(*SPEC[:4], priors=pcfg.priors)
    streams, seeds, dropped = replay_stream_batch(1, 2, "batched", spec,
                                                  pcfg, 3, device="cpu")
    assert streams.c0.shape == (3, pcfg.n_steps, pcfg.max_arrivals)
    assert len(seeds) == 3 and dropped >= 0
    run = make_run(pcfg, np.asarray(GRID), FIRST, device="cpu")
    res = calibrate_scenario(run, FIRST, "batched", streams, seeds,
                             capacity=CFG.capacity, tau=TAU,
                             stationary_theta=0.7 * CFG.capacity, n_grid=3,
                             max_stages=1)
    assert 0.0 < res.stationary_util <= 1.0
    assert res.retuned.n_sims == 9
