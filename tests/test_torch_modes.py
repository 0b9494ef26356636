"""Runs and calibration in the §6–§7 prior modes, the port against the
JAX package on the JAX package's own draws.

At ``SimCache`` size (``tests/conftest.py``: 30 steps, 96 slots, 12 grid
points, six keys), in each mode a port ``make_run`` fed the JAX package's
pre-drawn stream (with ``bel_alt``) and per-step events
(``torch_lockstep``) gives the JAX package's runs: failure and request
counts equal, utilization to rtol 1e-5 (``test_torch_sim.py``'s), with
Def. 4's marginal heuristic, as the figures' drivers run it. A batch
equals its runs alone bit for bit on the port's own draws in every mode.
Calibration in these modes: ``test_torch_modes_calibrate.py``.
"""
import numpy as np
import pytest
import torch

from repro.sim import make_run as r_make_run
from repro.tuning import eval_theta_grid as r_eval_theta_grid
from repro_torch.core import FIRST, SECOND, make_policy
from repro_torch.sim import MIX_LABELED, MIX_UNLABELED, PSEUDO, make_run
from repro_torch.tuning import eval_theta_grid
from torch_lockstep import InjectedRuns, port_config

RTOL_METRICS = 1e-5
MODES = {"pseudo5": (PSEUDO, 5), "pseudo50": (PSEUDO, 50),
         "labeled": (MIX_LABELED, 5), "unlabeled": (MIX_UNLABELED, 5)}
#: probe ladders (parameter space) across the SimCache config's range
LADDERS = {FIRST: (150.0, 300.0, 450.0), SECOND: (0.002, 0.03, 0.4)}


def _cfg(sim_cache, mode):
    prior_mode, n_obs = MODES[mode]
    return sim_cache.cfg._replace(prior_mode=prior_mode, n_pseudo_obs=n_obs)


@pytest.mark.parametrize("mode, kind", [
    ("pseudo5", FIRST), ("pseudo5", SECOND), ("pseudo50", FIRST),
    ("pseudo50", SECOND), ("labeled", SECOND), ("unlabeled", SECOND)],
    ids=["pseudo5-first", "pseudo5-second", "pseudo50-first",
         "pseudo50-second", "labeled-second", "unlabeled-second"])
def test_runs_match_reference(sim_cache, mode, kind):
    cfg = _cfg(sim_cache, mode)
    thetas = list(LADDERS[kind])
    want = r_eval_theta_grid(r_make_run(cfg, sim_cache.grid, kind), kind,
                             thetas, sim_cache.keys, capacity=cfg.capacity,
                             marginal=True)
    runs = InjectedRuns(cfg, sim_cache.grid, sim_cache.keys, kind)
    got = eval_theta_grid(runs, kind, thetas, range(len(sim_cache.keys)),
                          capacity=cfg.capacity, marginal=True)
    for name in ("failed_requests", "total_requests", "arrivals_accepted",
                 "slot_overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.utilization.numpy(),
                               np.asarray(want.utilization),
                               rtol=RTOL_METRICS)
    assert np.asarray(want.arrivals_accepted).sum() > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_equals_its_runs_alone(sim_cache, mode):
    cfg = port_config(_cfg(sim_cache, mode))
    run = make_run(cfg, np.asarray(sim_cache.grid), SECOND, device="cpu")
    rho = [0.01, 0.05, 0.2]
    batch = run([3, 4, 5], make_policy(SECOND, rho=rho, capacity=cfg.capacity,
                                       marginal=True))
    for r, seed in enumerate((3, 4, 5)):
        alone = run(seed, make_policy(SECOND, rho=rho[r],
                                      capacity=cfg.capacity, marginal=True))
        for name in alone._fields:
            assert torch.equal(getattr(batch, name)[r],
                               getattr(alone, name)), (mode, seed, name)
    assert float(batch.arrivals_accepted.sum()) > 0
