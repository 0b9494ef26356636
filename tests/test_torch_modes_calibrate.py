"""Calibration in the §6–§7 prior modes, the port against the JAX package
on the JAX package's own draws (``torch_lockstep.InjectedRuns``).

At ``SimCache`` size (``tests/conftest.py``), with Def. 4's marginal
heuristic as the figures' drivers run it, ``calibrate`` picks the JAX
package's theta, ``feasible``, ``n_sims``, stage thetas and failure rates,
utilization to rtol 1e-5, for Fig. 2's two modes (SECOND, labeled and
unlabeled, 5 observations) and one Fig. 1 level (FIRST, 5 observations).
"""
import numpy as np
import pytest

from repro.sim import make_run as r_make_run
from repro.tuning import calibrate as r_calibrate
from repro_torch.core import FIRST, SECOND
from repro_torch.tuning import calibrate
from test_torch_modes import RTOL_METRICS, _cfg
from torch_lockstep import InjectedRuns


@pytest.mark.parametrize("mode, kind", [("labeled", SECOND),
                                        ("unlabeled", SECOND),
                                        ("pseudo5", FIRST)],
                         ids=["fig2-labeled", "fig2-unlabeled",
                              "fig1-obs5-first"])
def test_calibrate_matches_reference(sim_cache, mode, kind):
    cfg = _cfg(sim_cache, mode)
    kw = dict(capacity=cfg.capacity, tau=sim_cache.tau, n_grid=6,
              max_stages=2, marginal=True)
    want = r_calibrate(r_make_run(cfg, sim_cache.grid, kind), kind,
                       sim_cache.keys, **kw)
    got = calibrate(InjectedRuns(cfg, sim_cache.grid, sim_cache.keys, kind),
                    kind, range(len(sim_cache.keys)), **kw)
    assert got.theta == want.theta
    assert got.feasible == want.feasible
    assert got.n_sims == want.n_sims
    assert len(got.stages) == len(want.stages)
    for g, w in zip(got.stages, want.stages):
        np.testing.assert_array_equal(g.thetas, w.thetas)
        np.testing.assert_array_equal(g.agg_fail, w.agg_fail)
        np.testing.assert_allclose(g.util, w.util, rtol=RTOL_METRICS)
    assert got.utilization == pytest.approx(want.utilization,
                                            rel=RTOL_METRICS)
