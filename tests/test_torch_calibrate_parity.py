"""The port's calibration against the reference's, on the same draws.

The port's ``eval_theta_grid`` and ``calibrate`` drive a port ``make_run``
fed the reference's own draws for whatever (key, theta) they ask for
(``torch_lockstep``); the reference's run on the same ``SimCache`` keys
(``tests/conftest.py``). Failure and request counts must be equal,
utilizations equal to rtol 1e-5 (``test_torch_sim.py``'s), and the chosen
theta, ``feasible``, ``n_sims`` and every stage's thetas and failure rates
equal, on explicit thetas and on the multi-stage path.
"""
import numpy as np
import pytest

from repro.tuning import calibrate as r_calibrate
from repro.tuning import eval_theta_grid as r_eval_theta_grid
from repro_torch.core import FIRST, SECOND, ZEROTH
from repro_torch.tuning import calibrate, eval_theta_grid
from torch_lockstep import InjectedRuns

KINDS = (ZEROTH, FIRST, SECOND)
IDS = ["zeroth", "first", "second"]
#: probe ladders (parameter space), as tests/test_tuning.py's
LADDERS = {
    ZEROTH: tuple(np.linspace(100.0, 500.0, 9)),
    FIRST: tuple(np.linspace(100.0, 525.0, 9)),
    SECOND: tuple(10.0 ** np.linspace(-3.7, -0.05, 9)),
}
RTOL_METRICS = 1e-5


@pytest.fixture(scope="module")
def injected(sim_cache):
    return {kind: InjectedRuns(sim_cache.cfg, sim_cache.grid, sim_cache.keys,
                               kind) for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_eval_theta_grid_matches_reference(sim_cache, injected, kind):
    thetas = list(LADDERS[kind])
    cap = sim_cache.cfg.capacity
    want = r_eval_theta_grid(sim_cache.run(kind), kind, thetas,
                             sim_cache.keys, capacity=cap)
    got = eval_theta_grid(injected[kind], kind, thetas,
                          range(len(sim_cache.keys)), capacity=cap)
    for name in ("failed_requests", "total_requests"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.utilization.numpy(),
                               np.asarray(want.utilization),
                               rtol=RTOL_METRICS)
    assert np.asarray(want.failed_requests).sum() > 0


def _same_result(got, want):
    assert got.theta == want.theta
    assert got.feasible == want.feasible
    assert got.n_sims == want.n_sims
    assert got.space == want.space
    assert len(got.stages) == len(want.stages)
    for g, w in zip(got.stages, want.stages):
        np.testing.assert_array_equal(g.thetas, w.thetas)
        np.testing.assert_array_equal(g.agg_fail, w.agg_fail)
        np.testing.assert_allclose(g.util, w.util, rtol=RTOL_METRICS)
    assert (got.sla_fail, got.sla_lo, got.sla_hi) == pytest.approx(
        (want.sla_fail, want.sla_lo, want.sla_hi), rel=1e-12, abs=1e-15)
    assert got.utilization == pytest.approx(want.utilization,
                                            rel=RTOL_METRICS)


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit_thetas", "multi_stage"])
@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_calibrate_matches_reference(sim_cache, injected, kind, explicit):
    kw = (dict(thetas=list(LADDERS[kind])) if explicit
          else dict(n_grid=6, max_stages=2))
    common_kw = dict(capacity=sim_cache.cfg.capacity, tau=sim_cache.tau,
                     **kw)
    want = r_calibrate(sim_cache.run(kind), kind, sim_cache.keys,
                       **common_kw)
    got = calibrate(injected[kind], kind, range(len(sim_cache.keys)),
                    **common_kw)
    _same_result(got, want)


