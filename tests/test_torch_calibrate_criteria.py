"""The reference's two statistical calibration properties, with its own
criteria, through the port's calibration on the reference's draws.

``tests/test_tuning.py`` holds the reference's calibration to two
properties of the empirical SLA curve on its ``SimCache`` keys: the
aggregate failure rate is nondecreasing in theta up to a fixed allowance
(``MONOTONE_TOL``, one run-level fluke), and the batched search ends within
one grid step of the serial ``tune_threshold`` bisection. Here the port's
``eval_theta_grid``, ``calibrate`` and ``tune_threshold`` run over a port
``make_run`` fed the reference's own draws for each (key, theta) they ask
for (``torch_lockstep.InjectedRuns``), and are held to the same
criteria, unchanged. (``test_torch_calibrate.py`` states the same
properties on the port's own draws, where a single run's divergence is
judged against the rate's own interval.)
"""
import numpy as np
import pytest

from repro_torch.core import tune_threshold
from repro_torch.tuning import (calibrate, eval_theta_grid, from_param,
                                theta_space, to_param)
from test_torch_calibrate_parity import IDS, KINDS, LADDERS
from torch_lockstep import InjectedRuns
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

#: tests/test_tuning.py's allowance: one run-level fluke
MONOTONE_TOL = 1.5e-3


@pytest.fixture(scope="module")
def injected(sim_cache):
    return {kind: InjectedRuns(sim_cache.cfg, sim_cache.grid, sim_cache.keys,
                               kind) for kind in KINDS}


def _agg_fail(sim_cache, run, kind, thetas):
    m = eval_theta_grid(run, kind, list(thetas), range(len(sim_cache.keys)),
                        capacity=sim_cache.cfg.capacity)
    fails = m.failed_requests.numpy()
    reqs = m.total_requests.numpy()
    return fails.sum(1) / np.maximum(reqs.sum(1), 1.0)


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_sla_failure_monotone_in_theta_on_reference_draws(sim_cache,
                                                           injected, kind):
    agg = _agg_fail(sim_cache, injected[kind], kind, LADDERS[kind])
    for lo in range(len(agg)):
        for hi in range(lo, len(agg)):
            assert agg[lo] <= agg[hi] + MONOTONE_TOL, (kind, lo, hi, agg)


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_batched_calibrate_matches_serial_bisection_on_reference_draws(
        sim_cache, injected, kind):
    cfg, tau = sim_cache.cfg, sim_cache.tau
    x_lo, x_hi, space = theta_space(kind, cfg.capacity)

    def run_sla(x):
        return float(_agg_fail(sim_cache, injected[kind], kind,
                               [to_param(x, space)])[0])

    x_serial = tune_threshold(run_sla, x_lo, x_hi, target_sla=tau, iters=9)
    res = calibrate(injected[kind], kind, range(len(sim_cache.keys)),
                    capacity=cfg.capacity, tau=tau, n_grid=9, max_stages=2)
    assert res.space == space
    x_batched = from_param(res.theta, space)
    assert abs(x_batched - x_serial) <= res.grid_step + 1e-9, (
        kind, x_batched, x_serial, res.grid_step)
