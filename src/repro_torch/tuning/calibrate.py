"""Batched SLA-constrained policy calibration (paper §5.2, as a subsystem).

The paper tunes every admission policy's free parameter by binary search
subject to the SLA. The serial oracle (``core.policies.tune_threshold``)
pays one full simulation batch per probe; here a whole candidate grid is
evaluated in **one** batched run:

  * the theta grid [T] and the run seeds [R] are flattened into one [T*R]
    batch of (seed, theta[, stream]) runs, pushed through ``make_run``'s
    batched loop (``sim.run_keyed_batch``) with [T*R] policy leaves;
  * run seeds are **shared across thetas** (common random numbers): each
    run draws from its own generator, so runs (theta, r) and (theta', r)
    see the same arrivals, and the same events until their trajectories
    diverge, wherever they sit in the batch;
  * selection is by **value**, not grid position: the largest feasible theta
    wins, so the result is invariant to grid permutation and to the order
    of the seeds;
  * refinement stages tighten the grid around the winner only while the SLA
    estimate's confidence interval still straddles the target (CI-aware
    stopping).

PyTorch counterpart of ``repro.tuning.calibrate``. The JAX package keeps
compiled, device-sharded evaluators in a cache (``_EVAL_CACHE``); the port
runs eagerly, so it has nothing to compile, and splits the flat batch over
``devices`` through ``sim.run_keyed_batch`` (default: the visible devices
of the run's kind), padding a ragged one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.policies import SECOND, ZEROTH, make_policy
from ..sim.core import ArrivalStream
from ..sim.simulator import _tree_map, run_keyed_batch

#: search-space coordinates per policy kind: SECOND tunes the Cantelli rho on
#: a log10 grid (the feasible range spans ~4 decades); the threshold kinds
#: tune cores linearly as fractions of capacity.
SPACE_LINEAR, SPACE_LOG10 = "linear", "log10"


def theta_space(kind: int, capacity: float,
                lo: Optional[float] = None,
                hi: Optional[float] = None) -> tuple[float, float, str]:
    """Default (lo, hi, space) search bounds for a policy kind, in search
    coordinates: raw cores for the threshold policies, log10(rho) for the
    second-moment policy. Explicit ``lo``/``hi`` override the defaults."""
    if kind == SECOND:
        return (np.log10(2e-4) if lo is None else lo,
                np.log10(0.9) if hi is None else hi, SPACE_LOG10)
    return (0.2 * capacity if lo is None else lo,
            (1.0 if kind == ZEROTH else 1.05) * capacity if hi is None else hi,
            SPACE_LINEAR)


def to_param(x, space: str):
    """Search coordinate -> policy parameter."""
    return 10.0 ** x if space == SPACE_LOG10 else x


def from_param(p, space: str):
    """Policy parameter -> search coordinate."""
    return np.log10(p) if space == SPACE_LOG10 else p


def sla_ci(fails: np.ndarray, reqs: np.ndarray,
           z: float = 1.96) -> tuple[float, float, float]:
    """Cluster-robust normal CI for the aggregate SLA failure rate.

    Failures are concentrated in tail runs, so each *run* is the sampling
    unit (ratio estimator over run totals, variance from run-level
    residuals). Returns ``(rate, lo, hi)``; a batch with zero observed
    failures has a degenerate [0, 0] interval.
    """
    f = np.asarray(fails, dtype=np.float64)
    r = np.asarray(reqs, dtype=np.float64)
    n = len(f)
    tot_r = max(r.sum(), 1.0)
    rate = f.sum() / tot_r
    if n < 2:
        return float(rate), float(rate), float(rate)
    resid = f - rate * r
    var = np.sum(resid**2) * n / (n - 1)
    se = np.sqrt(var) / tot_r
    return float(rate), float(max(rate - z * se, 0.0)), float(rate + z * se)


@dataclasses.dataclass(frozen=True)
class ProbeStage:
    """One evaluated candidate grid: thetas (parameter space) with the
    aggregate failure rate and per-run utilizations measured at each."""

    thetas: np.ndarray      # [T] parameter-space candidates
    agg_fail: np.ndarray    # [T] aggregate failure rate over the run batch
    util: np.ndarray        # [T, R] per-run utilizations


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Output of ``calibrate``: the tuned parameter plus the evidence."""

    kind: int
    theta: float            # tuned parameter (largest SLA-feasible candidate)
    feasible: bool          # did any candidate meet the SLA?
    tau: float              # the SLA target calibrated against
    sla_fail: float         # measured aggregate failure rate at theta
    sla_lo: float           # cluster-robust CI on sla_fail
    sla_hi: float
    separated: bool         # CI no longer straddles tau (stopping condition)
    utilization: float      # mean utilization at theta
    util_runs: np.ndarray   # [R] per-run utilizations at theta (for BCa CIs)
    grid_step: float        # final-stage grid spacing, search coordinates
    space: str              # SPACE_LINEAR | SPACE_LOG10
    stages: tuple           # tuple[ProbeStage] — every grid evaluated
    n_sims: int             # total full simulations spent


def eval_theta_grid(run_fn, kind: int, thetas, keys, *, capacity: float,
                    marginal: bool = False,
                    streams: Optional[ArrivalStream] = None,
                    devices=None, policy_fn=None):
    """Evaluate a whole [T] parameter grid over a shared [R] batch of run
    seeds (``keys``) in one batched run of ``run_fn`` (a ``make_run``
    run); returns ``RunMetrics`` with leading shape [T, R].

    The flat batch holds thetas repeated R times and the seeds tiled T
    times (run t R + r is (thetas[t], keys[r])); ``streams`` (a stacked [R]
    batch) is tiled the same way. ``policy_fn(thetas)`` overrides how the
    flat [T*R] thetas become ``PolicyParams`` ([T*R] leaves). With a fleet
    ``run_fn`` (a ``make_fleet_run`` run) pass a ``fleet_policy`` closure,
    e.g. ``lambda th: fleet_policy(kind, capacities=caps, rho=th)``, which
    gives [T*R, C] leaves, and ``capacity`` the fleet total; the returned
    ``FleetMetrics`` reshape the same way (``per_cluster`` to [T, R, C]).

    The flat batch goes over ``devices`` (``sim.run_keyed_batch``): a flat
    batch that does not divide the device count is padded to the next
    multiple (repeating its last run) and sliced afterwards, never left
    unsplit; the result equals one batch on one device bit for bit.
    """
    thetas = torch.as_tensor(np.asarray(thetas, dtype=np.float32))
    keys = list(keys)
    t_n, r_n = thetas.shape[0], len(keys)
    thetas_flat = thetas.repeat_interleave(r_n)
    keys_flat = keys * t_n
    if policy_fn is None:
        policy = make_policy(kind, threshold=thetas_flat, rho=thetas_flat,
                             capacity=capacity, marginal=marginal)
    else:
        policy = policy_fn(thetas_flat)
    if streams is not None:
        streams = _tree_map(
            lambda x: x.repeat((t_n,) + (1,) * (x.ndim - 1)), streams)
    metrics = run_keyed_batch(run_fn, keys_flat, policy, streams=streams,
                              devices=devices)
    return _tree_map(lambda x: x.reshape((t_n, r_n) + x.shape[1:]), metrics)


def calibrate(
    run_fn,
    kind: int,
    keys,
    *,
    capacity: float,
    tau: float,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
    n_grid: int = 8,
    thetas: Optional[Sequence[float]] = None,
    max_stages: int = 3,
    marginal: bool = False,
    streams: Optional[ArrivalStream] = None,
    devices=None,
    z: float = 1.96,
    policy_fn=None,
) -> CalibrationResult:
    """SLA-constrained calibration of one policy's free parameter.

    Evaluates candidate grids of ``n_grid`` thetas (each grid in one batched
    run over the shared ``keys``, the run seeds), picks the largest
    candidate whose aggregate failure rate meets ``tau``, and tightens the
    grid around the winner for up to ``max_stages`` stages, stopping early
    once the winner's SLA confidence interval separates from ``tau``
    (``sla_ci``).

    ``thetas`` (parameter space) overrides the generated grid and implies a
    single stage. ``streams`` calibrates against a fixed stacked [R]
    arrival-stream batch instead of prior-sampled arrivals.
    ``policy_fn(thetas)`` overrides candidate-policy construction: a
    ``fleet_policy`` closure calibrates a fleet run against the fleet SLA
    (``capacity`` then the fleet total, which sets the threshold kinds'
    search bounds).

    The result is invariant to permutation of the candidate grid and to the
    order of the keys: selection is by candidate value, and every candidate
    sees the same runs.
    """
    x_lo, x_hi, space = theta_space(kind, capacity, lo, hi)
    x0_lo, x0_hi = x_lo, x_hi
    explicit = thetas is not None
    if explicit:
        max_stages = 1

    stages = []
    n_sims = 0
    best = None
    for _stage in range(max_stages):
        if explicit:
            theta_vec = np.asarray(thetas, dtype=np.float64)
            xs = from_param(theta_vec, space)
        else:
            xs = np.linspace(x_lo, x_hi, n_grid)
            theta_vec = np.asarray([to_param(x, space) for x in xs])
        m = eval_theta_grid(run_fn, kind, theta_vec, keys, capacity=capacity,
                            marginal=marginal, streams=streams,
                            devices=devices, policy_fn=policy_fn)
        fails = m.failed_requests.cpu().numpy()     # [T, R]
        reqs = m.total_requests.cpu().numpy()
        utils = m.utilization.cpu().numpy()
        n_sims += fails.size
        agg_fail = fails.sum(1) / np.maximum(reqs.sum(1), 1.0)
        stages.append(ProbeStage(thetas=theta_vec, agg_fail=agg_fail,
                                 util=utils))

        feasible = agg_fail <= tau
        if feasible.any():
            # by value, not index: invariant to the grid's order
            idx = int(np.argmax(np.where(feasible, theta_vec, -np.inf)))
            any_feasible = True
        else:
            idx = int(np.argmin(theta_vec))
            any_feasible = False
        rate, ci_lo, ci_hi = sla_ci(fails[idx], reqs[idx], z=z)
        span = ((np.max(xs) - np.min(xs)) / max(len(xs) - 1, 1)
                if len(xs) > 1 else 0.0)
        best = {
            "theta": float(theta_vec[idx]), "feasible": any_feasible,
            "sla_fail": rate, "sla_lo": ci_lo, "sla_hi": ci_hi,
            "util_runs": utils[idx], "grid_step": float(span),
        }
        separated = not (ci_lo <= tau <= ci_hi)
        if separated or span == 0.0:
            break
        # tighten around the winner (search coordinates), clipped to the
        # original bounds so refinement never escapes the search space
        x_star = from_param(best["theta"], space)
        x_lo = max(x_star - span, x0_lo)
        x_hi = min(x_star + span, x0_hi)

    return CalibrationResult(
        kind=kind, theta=best["theta"], feasible=best["feasible"], tau=tau,
        sla_fail=best["sla_fail"], sla_lo=best["sla_lo"],
        sla_hi=best["sla_hi"], separated=separated,
        utilization=float(np.mean(best["util_runs"])),
        util_runs=np.asarray(best["util_runs"]),
        grid_step=best["grid_step"], space=space, stages=tuple(stages),
        n_sims=n_sims,
    )
