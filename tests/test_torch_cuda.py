"""The port's CUDA kernels and simulator on a card (marked ``cuda``; skipped
where no card is visible). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
inputs (the JAX package's kernel tolerances, rtol 2e-4 on EL and 2e-3 on VL),
and a small simulator run on the card must repeat bit for bit and conserve
deployments.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from repro_torch.core.belief import GammaBelief
from repro_torch.kernels.moment_curves import kernel as K
from repro_torch.kernels.moment_curves import ops
from repro_torch.kernels.moment_curves import ref as R
from repro_torch.sim import make_config, make_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(d, n, nd, device):
    rng = np.random.default_rng(d + n + nd)
    e = lambda base: torch.from_numpy(
        (base * np.exp(rng.standard_normal(d))).astype(np.float32))
    bel = GammaBelief(e(0.31), e(0.58), e(0.49), e(0.45), e(0.26), e(0.055))
    cores = torch.from_numpy((1.0 + rng.poisson(5.0, d)).astype(np.float32))
    alive = torch.from_numpy(rng.random(d) < 0.6)
    params = ops._pack(bel, cores, AZURE_PRIORS, alive=alive).to(device)
    return (params, *ops._grids(geometric_grid(6.0, 78_840.0, n,
                                               device=device), nd))


@pytest.mark.parametrize("d,n,nd", [(1, 12, 8), (8, 48, 24), (300, 48, 32),
                                    (8193, 48, 24)])
@pytest.mark.parametrize("which", ["rows", "agg"])
def test_kernel_matches_plain_version(card, which, d, n, nd):
    kern, plain = ((K.moment_curves_packed, R.moment_curves_packed_ref)
                   if which == "rows" else
                   (K.moment_curves_agg_packed,
                    R.moment_curves_agg_packed_ref))
    args = _packed(d, n, nd, card)
    before = dict(K.LAUNCHES)
    el, vl = kern(*args, nd)
    el2, vl2 = kern(*args, nd)
    torch.cuda.synchronize()
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 2
    assert torch.equal(el, el2) and torch.equal(vl, vl2)
    want_el, want_vl = plain(*args, nd)
    torch.testing.assert_close(el, want_el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(vl, want_vl, rtol=2e-3, atol=1e-4)


def test_card_run_is_deterministic_and_conserves(card):
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    K.reset_launches()
    (m1, a1), (m2, a2) = run(1, policy), run(1, policy)
    assert K.LAUNCHES == {"moment_curves_packed": 2 * cfg.n_steps,
                          "moment_curves_agg_packed": 2 * cfg.n_steps // 3}
    assert torch.equal(a1, a2)
    for x, y in zip(m1, m2):
        assert torch.equal(x, y)
    assert float(m1.alive_end) == float(
        m1.arrivals_accepted - m1.slot_overflow - m1.n_departed)
    assert 0.0 < float(m1.utilization) <= 1.0
