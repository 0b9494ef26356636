"""Fleet calibration against the JAX package's ``calibrate(...,
policy_fn=fleet_policy closure)`` on the same draws at the ``tiny`` preset
(the JAX package's fleet benchmark's split: four clusters of 40/30/20/10% of
the capacity, half the slots each): the same theta, and the candidates'
SLA rates and the winner's utilizations within rtol 1e-5.
"""
import jax
import numpy as np
import pytest

from repro.core import SECOND
from repro.core import fleet_policy as j_fleet_policy
from repro.sim import ROUTERS as J_ROUTERS
from repro.sim import FleetConfig as JFleetConfig
from repro.sim import make_fleet_run as j_make_fleet_run
from repro_torch import bridge
from repro_torch.core import fleet_policy
from repro_torch.sim import ROUTERS, make_fleet_run
from torch_lockstep import (fleet_policies, port_fleet_config,
                            reference_fleet_draws)



class InjectedFleetRuns:
    """A port ``make_fleet_run`` run fed the JAX package's draws: run seeds
    are indices into ``keys``; each (key, theta) asked for is recorded once
    by ``reference_fleet_draws``."""

    def __init__(self, fcfg, grid, keys, kind, router_name):
        self.fcfg, self.kind, self.router = fcfg, kind, router_name
        self.grid, self.keys = grid, np.asarray(keys)
        self.run = make_fleet_run(port_fleet_config(fcfg), np.asarray(grid),
                                  kind, router=ROUTERS[router_name](),
                                  device="cpu")
        self.draws = {}

    def __call__(self, seeds, policy, stream=None):
        assert stream is None
        thetas = policy.rho[:, 0].numpy().tolist()
        wanted = list(zip(seeds, thetas))
        new = sorted(set(wanted) - set(self.draws))
        if new:
            caps = self.fcfg.capacities
            stream, events, draws = reference_fleet_draws(
                self.fcfg, self.grid, self.kind,
                self.keys[[i for i, _ in new]],
                fleet_policies(self.kind, caps, [th for _, th in new]),
                self.router)
            for b, run in enumerate(new):
                self.draws[run] = (
                    jax.tree.map(lambda x: x[b], stream),
                    [jax.tree.map(lambda x: x[b], ev) for ev in events],
                    [None if d is None else jax.tree.map(lambda x: x[b], d)
                     for d in draws])
        picked = [self.draws[run] for run in wanted]
        stack = lambda trees: jax.tree.map(lambda *xs: np.stack(xs), *trees)
        stream = stack([s for s, _, _ in picked])
        events = [stack(step) for step in zip(*(e for _, e, _ in picked))]
        draws = [None if step[0] is None else stack(step)
                 for step in zip(*(d for _, _, d in picked))]
        return self.run(list(seeds), policy,
                        stream=bridge.from_reference(stream),
                        events=[bridge.from_reference(ev) for ev in events],
                        route_draws=draws)


def test_fleet_calibration_matches_jax_at_tiny():
    from repro.tuning import calibrate as j_calibrate
    from repro_torch.tuning import calibrate
    from benchmarks.common import SCALES, grid_for, sim_config

    scale = SCALES["tiny"]
    cfg = sim_config(scale)
    caps = tuple(round(f * scale.capacity, 1) for f in (0.4, 0.3, 0.2, 0.1))
    fcfg = JFleetConfig(base=cfg._replace(max_slots=cfg.max_slots // 2),
                        capacities=caps)
    grid = grid_for(scale, cfg)
    keys = jax.random.split(jax.random.PRNGKey(0), scale.n_runs)
    name = "least_utilized"
    kw = dict(capacity=fcfg.total_capacity, tau=scale.tau,
              n_grid=scale.n_thresholds, max_stages=1)
    want = j_calibrate(
        j_make_fleet_run(fcfg, grid, SECOND, router=J_ROUTERS[name]()),
        SECOND, keys,
        policy_fn=lambda th: j_fleet_policy(SECOND, capacities=caps, rho=th),
        **kw)
    runs = InjectedFleetRuns(fcfg, grid, keys, SECOND, name)
    got = calibrate(
        runs, SECOND, list(range(scale.n_runs)),
        policy_fn=lambda th: fleet_policy(SECOND, capacities=caps, rho=th),
        **kw)
    assert got.theta == pytest.approx(want.theta, rel=1e-6)
    assert got.feasible == want.feasible
    np.testing.assert_allclose(got.stages[0].agg_fail,
                               want.stages[0].agg_fail, rtol=1e-5)
    np.testing.assert_allclose(got.util_runs, want.util_runs, rtol=1e-5)
