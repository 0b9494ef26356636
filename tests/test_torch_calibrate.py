"""The port's calibration subsystem, its K-curve and run metrics, on the CPU
(parity with the reference: ``test_torch_calibrate_parity.py``).

* The properties of ``tests/test_tuning.py`` on the port's own draws: SLA
  failure monotone in theta, invariance to the grid's and the keys' order,
  the calibrated theta meeting the measured SLA, the minimum when nothing
  is feasible, agreement with the serial ``tune_threshold`` bisection
  within one grid step; ``sla_ci``; the K-curve's rows and
  ``pick_agg_refresh``. Two of these are statistical: over 6 runs a
  larger theta can fail fewer requests, when one run's trajectory
  diverges, by more than the fixed allowance (1.5e-3) that the
  reference's test meets on its keys; the reference's own draws break it
  for other key batches too. So here a drop in the failure rate, and a
  bisection misled by one, must be within the rate's own 95% interval
  (``sla_ci``): not significant.
* ``sim.metrics`` (the port's copy): the BCa interval covers the mean and
  equals the reference's on the same input.
"""
import json

import numpy as np
import pytest

from repro.core import geometric_grid as r_geometric_grid
from repro.sim import bca_ci as r_bca_ci
from repro.sim import sla_failure_rate as r_sla_failure_rate
from repro.tuning import pick_agg_refresh as r_pick_agg_refresh
from repro_torch.benchmarks import common, table2_policies
from repro_torch.core import FIRST, SECOND, ZEROTH, tune_threshold
from repro_torch.sim import (bca_ci, make_config, make_run,
                             sla_failure_rate, split_seeds)
from repro_torch.tuning import (KPoint, calibrate, eval_theta_grid,
                                format_kcurve_derived, from_param,
                                kcurve_divisors, kcurve_row_name,
                                parse_kcurve_rows, pick_agg_refresh,
                                pick_from_curve, sla_ci, sweep_kcurve,
                                theta_space, to_param)
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

KINDS = (ZEROTH, FIRST, SECOND)
IDS = ["zeroth", "first", "second"]
#: probe ladders (parameter space), as tests/test_tuning.py's
LADDERS = {
    ZEROTH: tuple(np.linspace(100.0, 500.0, 9)),
    FIRST: tuple(np.linspace(100.0, 525.0, 9)),
    SECOND: tuple(10.0 ** np.linspace(-3.7, -0.05, 9)),
}
MONOTONE_TOL = 1.5e-3     # tests/test_tuning.py's: one run-level fluke


class PortCache:
    """The ``SimCache`` configuration on the port's own draws: six run
    seeds, one run function a kind, memoized theta-grid evaluations:
    (aggregate failure rate [T], its ``sla_ci`` lower end [T],
    utilization [T, R])."""

    def __init__(self):
        self.cfg = make_config(capacity=500.0, arrival_rate=0.08,
                               horizon_hours=30 * 24.0, dt=24.0,
                               max_slots=96, max_arrivals=4, d_points=8)
        self.grid = np.asarray(r_geometric_grid(24.0, 3 * 30 * 24.0, 12))
        self.seeds = split_seeds(7, 6)
        self.tau = 5e-3
        self.runs = {kind: make_run(self.cfg, self.grid, kind, device="cpu")
                     for kind in KINDS}
        self._curves = {}

    def curve(self, kind, thetas):
        key = (kind, tuple(float(t) for t in thetas))
        if key not in self._curves:
            m = eval_theta_grid(self.runs[kind], kind, list(thetas),
                                self.seeds, capacity=self.cfg.capacity)
            fails = m.failed_requests.numpy()
            reqs = m.total_requests.numpy()
            self._curves[key] = (
                fails.sum(1) / np.maximum(reqs.sum(1), 1.0),
                np.array([sla_ci(f, r)[1] for f, r in zip(fails, reqs)]),
                m.utilization.numpy())
        return self._curves[key]


@pytest.fixture(scope="module")
def port():
    return PortCache()


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_sla_failure_monotone_in_theta(port, kind):
    """Larger theta admits more, so the failure rate does not fall
    significantly with theta: where it falls by more than the reference's
    allowance, the lower end of the smaller theta's 95% interval is not
    above the larger theta's rate. The ladder's ends: no failure at the
    smallest theta, some at the largest."""
    agg, ci_lo, _ = port.curve(kind, LADDERS[kind])
    for lo in range(len(agg)):
        for hi in range(lo, len(agg)):
            if agg[lo] > agg[hi] + MONOTONE_TOL:
                assert ci_lo[lo] <= agg[hi] + MONOTONE_TOL, (kind, lo, hi)
    assert agg[0] == 0.0 < agg[-1]


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_calibrate_invariant_to_grid_permutation_and_key_order(port, kind):
    thetas = list(LADDERS[kind])
    kw = dict(capacity=port.cfg.capacity, tau=port.tau)
    base = calibrate(port.runs[kind], kind, port.seeds, thetas=thetas, **kw)
    perm = list(np.random.default_rng(kind).permutation(thetas))
    for res in (calibrate(port.runs[kind], kind, port.seeds, thetas=perm,
                          **kw),
                calibrate(port.runs[kind], kind, port.seeds[::-1],
                          thetas=thetas, **kw)):
        assert res.theta == base.theta
        assert res.feasible == base.feasible
        assert res.sla_fail == pytest.approx(base.sla_fail, abs=1e-12)
        assert res.utilization == pytest.approx(base.utilization, rel=1e-6)


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_calibrated_theta_meets_measured_sla(port, kind):
    res = calibrate(port.runs[kind], kind, port.seeds,
                    capacity=port.cfg.capacity, tau=port.tau, n_grid=6,
                    max_stages=2)
    assert res.feasible
    assert res.sla_fail <= port.tau
    assert res.sla_lo <= res.sla_fail <= res.sla_hi
    final = res.stages[-1]
    at = np.argmin(np.abs(final.thetas - res.theta))
    assert final.agg_fail[at] <= port.tau


def test_infeasible_everywhere_flags_and_returns_min(port):
    thetas = list(LADDERS[ZEROTH][5:])
    agg, _, _ = port.curve(ZEROTH, thetas)
    assert (agg > 1e-9).all()   # every candidate fails the SLA below
    res = calibrate(port.runs[ZEROTH], ZEROTH, port.seeds,
                    capacity=port.cfg.capacity, tau=1e-9, thetas=thetas)
    assert not res.feasible
    assert res.theta == min(thetas)


@pytest.mark.parametrize("kind", KINDS, ids=IDS)
def test_batched_calibrate_matches_serial_bisection(port, kind):
    """The batched grid search and the serial bisection, on the same
    runs, end within one grid step of each other; or the bisection was
    turned down below the batched result by a failure rate above tau whose
    95% interval reaches below tau (a fluke it cannot tell from the SLA's
    edge, as ``test_sla_failure_monotone_in_theta`` allows)."""
    x_lo, x_hi, space = theta_space(kind, port.cfg.capacity)
    probes = []

    def run_sla(x):
        agg, ci_lo, _ = port.curve(kind, [to_param(x, space)])
        probes.append((x, float(agg[0]), float(ci_lo[0])))
        return float(agg[0])

    x_serial = tune_threshold(run_sla, x_lo, x_hi, target_sla=port.tau,
                              iters=9)
    res = calibrate(port.runs[kind], kind, port.seeds,
                    capacity=port.cfg.capacity, tau=port.tau, n_grid=9,
                    max_stages=2)
    assert res.space == space
    x_batched = from_param(res.theta, space)
    if abs(x_batched - x_serial) > res.grid_step + 1e-9:
        misled = [(x, rate, lo) for x, rate, lo in probes
                  if x < x_batched and rate > port.tau]
        assert x_serial < x_batched and misled, (kind, x_batched, x_serial)
        assert all(lo <= port.tau for _, _, lo in misled), misled


def test_tune_threshold_bisects():
    assert tune_threshold(lambda x: x / 100.0, 0.0, 100.0, 0.3,
                          iters=20) == pytest.approx(30.0, abs=1e-3)


class TestSlaCi:
    def test_zero_failures_degenerate_interval(self):
        rate, lo, hi = sla_ci(np.zeros(8), np.full(8, 100.0))
        assert rate == lo == hi == 0.0

    def test_covers_rate_and_orders(self):
        f = np.array([0.0, 2.0, 0.0, 7.0])
        r = np.array([100.0, 120.0, 90.0, 110.0])
        rate, lo, hi = sla_ci(f, r)
        assert lo <= rate <= hi
        assert rate == pytest.approx(9.0 / 420.0)

    def test_concentrated_failures_widen_interval(self):
        r = np.full(8, 100.0)
        lumpy = np.zeros(8)
        lumpy[0] = 8.0
        _, lo_e, hi_e = sla_ci(np.full(8, 1.0), r)
        _, lo_l, hi_l = sla_ci(lumpy, r)
        assert hi_l - lo_l > hi_e - lo_e


def _points():
    mk = lambda k, ur, sr, feas=True: KPoint(
        k=k, theta_fixed=0.1, util_fixed=ur - 0.01, slack_fixed=sr,
        theta_retuned=0.1, util_retuned=ur, slack_retuned=sr,
        retuned_feasible=feas)
    return [mk(1, 0.650, 2e-4), mk(2, 0.649, 2e-4), mk(4, 0.647, 1e-4),
            mk(8, 0.610, -1e-4)]


class TestKCurve:
    def test_divisors(self):
        assert kcurve_divisors(1096, 16) == [1, 2, 4, 8]
        assert kcurve_divisors(7, 4) == [1]

    def test_pick_from_curve(self):
        assert pick_from_curve(_points(), util_tol=1e-3) == 2
        assert pick_from_curve(_points(), util_tol=5e-3) == 4
        assert pick_from_curve([p for p in _points() if p.k >= 8]) == 8

    def test_row_round_trip(self):
        rows = [{"name": kcurve_row_name("quick", p.k),
                 "derived": format_kcurve_derived(p)} for p in _points()]
        back = parse_kcurve_rows(rows, "quick")
        assert [p.k for p in back] == [1, 2, 4, 8]
        for a, b in zip(_points(), back):
            assert b.util_retuned == pytest.approx(a.util_retuned, abs=1e-4)
            assert b.slack_retuned == pytest.approx(a.slack_retuned,
                                                    rel=1e-2)
            assert b.retuned_feasible == a.retuned_feasible
        assert parse_kcurve_rows(rows, "tiny") == []

    def test_pick_agg_refresh_from_bench_file(self, tmp_path):
        rows = [{"name": kcurve_row_name("quick", p.k), "us_per_call": 1.0,
                 "derived": format_kcurve_derived(p)} for p in _points()]
        path = tmp_path / "BENCH_quick.json"
        path.write_text(json.dumps({"scale": "quick", "rows": rows}))
        assert pick_agg_refresh("quick", fallback=99, bench_path=str(path),
                                util_tol=1e-3) == 2
        assert pick_agg_refresh("quick", fallback=99, bench_path=str(path),
                                util_tol=1e-3, n_steps=9) == 1
        assert pick_agg_refresh("tiny", fallback=4,
                                bench_path=str(path)) == 4
        assert pick_agg_refresh("quick", fallback=8, bench_path=str(
            tmp_path / "nope.json")) == 8

    def test_committed_bench_file_read_as_the_reference_reads_it(self):
        for scale in ("tiny", "quick", "full"):
            assert pick_agg_refresh(scale, fallback=5) == r_pick_agg_refresh(
                scale, fallback=5)

    def test_sweep_kcurve_on_the_cpu(self, port):
        cfg = port.cfg._replace(horizon_hours=12 * 24.0)
        points = sweep_kcurve(cfg, port.grid, ZEROTH, port.seeds[:3],
                              tau=port.tau, ks=[1, 3], n_grid=3,
                              max_stages=1, device="cpu")
        assert [p.k for p in points] == [1, 3]
        assert points[0].theta_fixed == points[1].theta_fixed
        assert pick_from_curve(points) in (1, 3)


def test_bca_ci_covers_mean():
    rng = np.random.default_rng(0)
    x = rng.normal(10.0, 2.0, size=100)
    ci = bca_ci(x, n_resamples=2_000)
    assert ci.lo < x.mean() < ci.hi
    assert ci.estimate == pytest.approx(x.mean())


@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_equal_the_references(weighted):
    rng = np.random.default_rng(3)
    x = rng.gamma(2.0, 0.2, size=24)
    w = rng.random(24) if weighted else None
    assert tuple(bca_ci(x, w, n_resamples=2_000, seed=5)) == tuple(
        r_bca_ci(x, w, n_resamples=2_000, seed=5))
    f, r = rng.poisson(1.0, 24), rng.poisson(100.0, 24)
    assert sla_failure_rate(f, r, w) == r_sla_failure_rate(f, r, w)


def test_table2_driver_on_the_cpu():
    """``tune_and_eval`` and Table 2's rows at the ``tiny`` preset's widths,
    its horizon cut to 24 steps."""
    scale = common.SCALES["tiny"]
    cfg = common.sim_config(scale, horizon_hours=24 * 12.0,
                            agg_refresh_steps=4)
    res = {name: common.tune_and_eval(scale, kind, cfg, seed=1,
                                      device="cpu")
           for kind, name in table2_policies.NAMES.items()}
    for r in res.values():
        assert r["feasible"] and r["sla_fail"] <= scale.tau
        assert r["ci_lo"] <= r["utilization"] <= r["ci_hi"]
        assert r["n_sims"] == scale.n_runs * sum(map(len, r["stages"]))
    rows = table2_policies.rows(res)
    assert [row.split(",")[0] for row in rows] == [
        "table2/zeroth", "table2/first", "table2/second"]
