"""``repro_torch.bridge`` carries the JAX package's state NamedTuples to the
port and back, matched by class name and fields."""
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from repro.core.moments import MomentCurves
from repro.sim import SimConfig, make_admission_core
from repro_torch import bridge
from repro_torch.core.moments import MomentCurves as TMomentCurves
from repro_torch.sim.core import CoreState as TCoreState
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

CFG = SimConfig(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
                dt=24.0, max_slots=16, max_arrivals=4, d_points=8,
                priors=AZURE_PRIORS)


def _leaves(tree):
    return [x for x in jax.tree.leaves(tuple(tree)) if x is not None]


def test_core_state_round_trip():
    ref = jax.tree.map(np.asarray, make_admission_core(
        CFG, geometric_grid(24.0, 2_160.0, 12), SECOND).init())
    port = bridge.from_reference(ref)
    assert isinstance(port, TCoreState) and port.tel is None
    assert port.slots.alive.dtype == torch.bool
    assert port.slots.cores.dtype == torch.float32
    back = bridge.to_numpy(port)
    want, got = _leaves(ref), _leaves(back)
    assert len(want) == len(got) == 20   # 18 slot-table leaves + 2 aggregates
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_policy_priors_and_curves():
    pol = bridge.from_reference(jax.tree.map(
        np.asarray, make_policy(SECOND, rho=0.1, capacity=500.0)))
    assert pol.kind.dtype == torch.int32 and pol.rho.dtype == torch.float32
    priors = bridge.from_reference(AZURE_PRIORS)
    assert type(priors).__module__.startswith("repro_torch")
    assert tuple(priors) == tuple(AZURE_PRIORS)
    curves = bridge.from_reference(MomentCurves(np.ones((2, 3), np.float32),
                                                np.zeros((2, 3), np.float32)))
    assert isinstance(curves, TMomentCurves) and curves.EL.shape == (2, 3)


def test_refuses_what_it_cannot_match():
    class Unknown(NamedTuple):
        x: np.ndarray

    class GammaBelief(NamedTuple):   # the right name, the wrong fields
        mu_a: np.ndarray

    with pytest.raises(TypeError, match="no port counterpart"):
        bridge.from_reference(Unknown(np.zeros(2)))
    with pytest.raises(TypeError, match="fields differ"):
        bridge.from_reference(GammaBelief(np.zeros(2)))
    with pytest.raises(TypeError, match="np.asarray"):
        bridge.from_reference(MomentCurves(jax.numpy.zeros(2),
                                           jax.numpy.zeros(2)))
