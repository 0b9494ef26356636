"""Drift-aware streaming recalibration: detect prior drift, re-tune warm.

The paper tunes each admission policy once against stationary Table-1 priors
and "re-tunes whenever the environment changes" — but its own motivating
multi-month traces drift, and the scenario sweep showed stationary-tuned
operating points violating the SLA badly under non-stationary arrivals.
This module closes that loop in three pieces:

  * **Channels** — per-window drift statistics derived from the same
    sufficient statistics both fitting paths accumulate: offline from
    ``traces.fit.window_stats`` (``FitStats.drift_channels()``), live from
    the telemetry rider's observable totals
    (``obs.counters.telemetry_summary()["obs"]`` deltas, the very sums
    ``core.belief.pseudo_counts_from_observables`` consumes). The offline
    channels are *unweighted means of per-deployment unbiased estimates*
    (mean deaths/core-hours, mean scale-outs/alive-hour, mean size-minus-1):
    pooled ratio rates are tilted by horizon censoring — deployments
    arriving late are observed briefly, which re-weights the heavy-tailed mu
    population toward fast-dying deployments and fakes a drift signal near
    the end of every trace — while the per-deployment estimates are
    conditionally unbiased under any censoring, so their window means are
    flat on a stationary trace.
  * **Detector** — ``DriftDetector``, a two-sided CUSUM over standardized
    channel deviations (Gaussian increments with slack ``k``; GLR-style in
    that the decision statistic is the max over channels and directions).
    The null (per-channel mean/std and the firing threshold) is **calibrated
    by Monte Carlo** on stationary replays of the same trace spec and window
    layout (``calibrate_drift_detector``): the threshold is the empirical
    (1 - alpha) quantile of the stationary max-statistic, so the false-alarm
    rate is <= alpha by construction and any residual window-layout effects
    are absorbed into the null.
  * **Re-tuning** — on trigger, ``retune_warm`` runs the batched
    ``tuning.calibrate`` pass on a *warm-started* grid: search bounds
    shrunk around the incumbent theta (``warm_theta_bounds``), so the
    re-tune costs a fraction of the cold calibration — escalating to the
    cold bounds when the warm window holds no feasible theta (a drift too
    large for the warm assumption). ``run_drift_protocol``
    measures what that buys: regret (utilization at matched SLA, infeasible
    operating points credited zero) of *never* re-tuning and of
    *detector-triggered* warm re-tuning against an *oracle* that re-tunes
    cold at the drift onset — the triggered arm pays for its detection
    delay with the incumbent's (usually zero-credit) utilization.

Everything here is a cold path: numpy on host, simulations through the same
``make_run``/``calibrate`` machinery the rest of the tuning subsystem uses.

PyTorch counterpart of ``repro.tuning.drift``: the same float64 host
arithmetic; traces are synthesized and runs simulated on the caller's
device, with seeds (``sim.split_seeds``) where the JAX package splits keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..obs.log import get_logger
from ..sim.simulator import split_seeds
from ..traces import (DRIFT_MU_SCALE, DRIFT_RAMP_FRACS, DRIFT_STEP_FRAC,
                      WorkloadTrace, drifted_priors, host_trace,
                      synthesize_scenario, window_stats)
from .calibrate import (CalibrationResult, calibrate, eval_theta_grid,
                        from_param, sla_ci, theta_space)

log = get_logger(__name__)

#: detector channels, in the order reports list them
DRIFT_CHANNELS = ("mu", "scaleout", "size")

#: drift onset (hours) of the shipped drifting scenarios, per horizon
_SCENARIO_ONSET = {
    "drift_step": lambda h: DRIFT_STEP_FRAC * h,
    "drift_ramp": lambda h: DRIFT_RAMP_FRACS[0] * h,
}


# ---------------------------------------------------------------------------
# Channels
# ---------------------------------------------------------------------------

def channels_from_stats(stats) -> dict:
    """Offline channel values of one ``traces.fit.FitStats`` window (the
    censoring-robust per-deployment means; see module docstring)."""
    return stats.drift_channels()


def channels_from_obs(obs: dict) -> dict:
    """Live channel values from one window's telemetry observable *deltas*
    (``telemetry_summary()["obs"]`` now minus previous scrape). Telemetry
    windows slice time, not arrivals, so the plain ratio rates are already
    censoring-free here: deaths per core-hour of exposure, scale-outs per
    alive-hour, and mean granted scale-out size. Channels with no exposure
    in the window are NaN and skipped by the detector."""
    deaths = float(obs.get("core_deaths", 0.0))
    exposure = float(obs.get("exposure_core_hours", 0.0))
    n_so = float(obs.get("n_scaleouts", 0.0))
    alive = float(obs.get("alive_hours", 0.0))
    so_cores = float(obs.get("scaleout_cores", 0.0))
    return {
        "mu": deaths / exposure if exposure > 0 else float("nan"),
        "scaleout": n_so / alive if alive > 0 else float("nan"),
        "size": (so_cores - n_so) / n_so if n_so > 0 else float("nan"),
    }


def window_channel_values(trace: WorkloadTrace,
                          window_hours: float) -> list[dict]:
    """Split a trace into consecutive arrival windows of ``window_hours``
    and return each window's channel values (offline replay feed). The
    trace's columns are read to the host once."""
    trace = host_trace(trace)
    horizon = float(trace.horizon_hours)
    n_w = max(int(math.ceil(horizon / window_hours - 1e-9)), 1)
    return [channels_from_stats(
        window_stats(trace, i * window_hours, (i + 1) * window_hours))
        for i in range(n_w)]


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftNull:
    """Calibrated null model of one detector deployment: per-channel mean
    and standard deviation of the window channel values on *stationary*
    replays, plus the Monte-Carlo firing threshold at ``alpha``."""

    mean: dict
    std: dict
    threshold: float
    alpha: float
    slack: float          # CUSUM drift allowance, in null-std units
    n_reps: int           # stationary replays behind the calibration
    n_windows: int        # windows per replay the threshold was set over


@dataclasses.dataclass(frozen=True)
class DriftUpdate:
    """One detector step: the decision statistic after this window."""

    window: int                    # 0-based index of the window just seen
    stat: float                    # max over channels/directions
    fired: bool                    # latched: has the detector ever fired?
    fired_window: Optional[int]    # first window at which it fired
    channel_stats: dict            # per-channel max(up, down) CUSUM values


class DriftDetector:
    """Two-sided CUSUM drift detector over standardized channel values.

    Per channel c and window value x: z = (x - mean_c) / std_c, then

        up_c   <- max(0, up_c   + z - k)      (channel rose)
        down_c <- max(0, down_c - z - k)      (channel fell)

    with slack ``k = null.slack``. The decision statistic is the max over
    channels and directions; the detector fires (and latches) when it
    exceeds ``null.threshold``. NaN channel values (quiet windows) skip
    that channel's update — the CUSUM holds its value.
    """

    def __init__(self, null: DriftNull):
        self.null = null
        self.reset()

    def reset(self) -> None:
        self._up = {c: 0.0 for c in self.null.mean}
        self._down = {c: 0.0 for c in self.null.mean}
        self.n_windows = 0
        self.fired = False
        self.fired_window: Optional[int] = None

    @property
    def stat(self) -> float:
        vals = [max(self._up[c], self._down[c]) for c in self._up]
        return max(vals) if vals else 0.0

    def update(self, values: dict) -> DriftUpdate:
        """Feed one window's channel values; returns the updated decision."""
        k = self.null.slack
        for c in self._up:
            x = values.get(c, float("nan"))
            sd = self.null.std.get(c, 0.0)
            if not np.isfinite(x) or not sd > 0:
                continue
            z = (x - self.null.mean[c]) / sd
            self._up[c] = max(0.0, self._up[c] + z - k)
            self._down[c] = max(0.0, self._down[c] - z - k)
        window = self.n_windows
        self.n_windows += 1
        if not self.fired and self.stat > self.null.threshold:
            self.fired = True
            self.fired_window = window
            log.info("drift detector fired at window %d (stat %.2f > %.2f)",
                     window, self.stat, self.null.threshold)
        return DriftUpdate(
            window=window, stat=self.stat, fired=self.fired,
            fired_window=self.fired_window,
            channel_stats={c: max(self._up[c], self._down[c])
                           for c in self._up})

    def snapshot(self) -> dict:
        """Flat metrics-endpoint view of the detector state."""
        return {
            "stat": self.stat,
            "threshold": self.null.threshold,
            "fired": int(self.fired),
            "fired_window": (-1 if self.fired_window is None
                             else self.fired_window),
            "n_windows": self.n_windows,
            "channel_stats": {c: max(self._up[c], self._down[c])
                              for c in self._up},
        }


def calibrate_drift_detector(seed: int, spec, *, window_hours: float,
                             n_reps: int = 12, alpha: float = 0.1,
                             slack: float = 0.5,
                             scenario: str = "baseline",
                             device="cuda") -> DriftNull:
    """Monte-Carlo null calibration on stationary replays.

    Synthesizes ``n_reps`` stationary traces of ``spec``, windows each with
    the *same* layout the detector will run with, pools the per-window
    channel values into the null mean/std, and sets the firing threshold to
    the empirical (1 - alpha) quantile (``method="higher"``, conservative)
    of the per-replay *max* CUSUM statistic — so a fresh stationary replay
    fires with probability <= alpha, whatever window-layout or residual
    censoring effects the spec carries.

    The replays are synthesized on ``device`` (the card unless the caller
    passes ``"cpu"``) from ``split_seeds(seed, n_reps)``.
    """
    device = resolve_device(device)
    reps = [window_channel_values(
        synthesize_scenario(s, scenario, spec, device=device), window_hours)
        for s in split_seeds(seed, n_reps)]
    return null_from_replays(reps, alpha=alpha, slack=slack)


def null_from_replays(reps: list, *, alpha: float = 0.1,
                      slack: float = 0.5) -> DriftNull:
    """The null of ``calibrate_drift_detector`` from its stationary
    replays' per-window channel values (``reps``: one list of channel dicts
    a replay)."""
    n_reps = len(reps)
    mean, std = {}, {}
    for c in DRIFT_CHANNELS:
        xs = np.asarray([v[c] for rep in reps for v in rep], np.float64)
        xs = xs[np.isfinite(xs)]
        mean[c] = float(xs.mean()) if xs.size else 0.0
        std[c] = float(max(xs.std(ddof=1), 1e-9)) if xs.size > 1 else 0.0

    probe = DriftNull(mean=mean, std=std, threshold=float("inf"),
                      alpha=alpha, slack=slack, n_reps=n_reps,
                      n_windows=len(reps[0]) if reps else 0)
    maxes = []
    for rep in reps:
        det = DriftDetector(probe)
        maxes.append(max(det.update(v).stat for v in rep))
    threshold = float(np.quantile(np.asarray(maxes), 1.0 - alpha,
                                  method="higher"))
    log.debug("drift null: threshold=%.3f (alpha=%.2g over %d reps x %d "
              "windows)", threshold, alpha, n_reps, probe.n_windows)
    return dataclasses.replace(probe, threshold=threshold)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One offline detector pass over a trace's replay windows."""

    fired: bool
    fired_window: Optional[int]
    n_windows: int
    window_hours: float
    stats: np.ndarray              # [W] decision-statistic trajectory


def detect_drift(trace: WorkloadTrace, null: DriftNull, *,
                 window_hours: float) -> DriftReport:
    """Run a freshly-reset detector over a trace's arrival windows."""
    det = DriftDetector(null)
    updates = [det.update(v)
               for v in window_channel_values(trace, window_hours)]
    return DriftReport(
        fired=det.fired, fired_window=det.fired_window,
        n_windows=len(updates), window_hours=float(window_hours),
        stats=np.asarray([u.stat for u in updates]))


# ---------------------------------------------------------------------------
# Warm re-tuning
# ---------------------------------------------------------------------------

def warm_theta_bounds(kind: int, theta0: float, capacity: float, *,
                      frac: float = 0.25) -> tuple[float, float]:
    """Search bounds (in search coordinates) for a warm re-tune: a window of
    ``frac`` of the cold search span on each side of the incumbent,
    clipped to the cold bounds."""
    x_lo, x_hi, space = theta_space(kind, capacity)
    x0 = float(from_param(theta0, space))
    half = frac * (x_hi - x_lo)
    return max(x0 - half, x_lo), min(x0 + half, x_hi)


def retune_warm(run_fn, kind: int, keys, *, capacity: float, tau: float,
                theta0: float, frac: float = 0.25, n_grid: int = 5,
                max_stages: int = 2, escalate: bool = True,
                escalate_grid: Optional[int] = None,
                devices=None) -> CalibrationResult:
    """Incremental re-calibration around the incumbent ``theta0``: the same
    batched ``tuning.calibrate`` pass on the shrunk
    ``warm_theta_bounds`` window — a fraction of the cold grid's
    simulations, because the incumbent is assumed near-feasible.

    When the drift has moved the feasible set beyond the warm window (every
    warm candidate violates the SLA), ``escalate=True`` (the default)
    re-runs on the full cold bounds rather than returning an infeasible
    operating point — the re-tune then costs cold price (both passes'
    simulations are accounted), but a large drift degrades to the cold
    calibration instead of to *no* feasible theta. ``escalate_grid`` sets
    the escalation pass's grid density (default: ``n_grid``) so a caller
    comparing against its own cold calibration can make the escalated pass
    literally that calibration."""
    lo, hi = warm_theta_bounds(kind, theta0, capacity, frac=frac)
    res = calibrate(run_fn, kind, keys, capacity=capacity, tau=tau,
                    lo=lo, hi=hi, n_grid=n_grid, max_stages=max_stages,
                    devices=devices)
    if escalate and not res.feasible:
        log.info("warm re-tune window [%.3g, %.3g] infeasible at tau=%g; "
                 "escalating to cold bounds", lo, hi, tau)
        cold = calibrate(run_fn, kind, keys, capacity=capacity, tau=tau,
                         n_grid=escalate_grid or n_grid,
                         max_stages=max_stages, devices=devices)
        res = dataclasses.replace(cold, n_sims=cold.n_sims + res.n_sims)
    return res


# ---------------------------------------------------------------------------
# The regret protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DriftArm:
    """One re-tuning strategy evaluated on the post-drift regime."""

    name: str
    theta: float
    feasible: bool         # SLA met at theta on the post-drift runs
    sla_fail: float
    util_raw: float        # mean utilization, ignoring SLA credit
    util: float            # credited: 0 when infeasible, delay-weighted
    regret: float          # oracle credited util minus this arm's
    n_sims: int


@dataclasses.dataclass(frozen=True)
class DriftProtocolResult:
    """Everything ``run_drift_protocol`` measured."""

    kind: int
    scenario: str
    theta0: float                  # stationary-calibrated incumbent
    base: CalibrationResult        # the stationary calibration
    null: DriftNull
    report: DriftReport            # detector pass over the drifting trace
    onset_window: int              # window the drift starts in
    delay_windows: int             # fired_window - onset_window (>= 0)
    delay_frac: float              # post-onset time spent undetected
    oracle: DriftArm
    triggered: DriftArm
    never: DriftArm
    oracle_ci: tuple               # normal CI on oracle credited util
    within_ci: bool                # triggered arm's post-re-tune credited
                                   # util >= oracle CI lower edge (the delay
                                   # cost is regret's job, not this flag's)
    n_sims: int


def _credit(util: float, feasible: bool) -> float:
    """Utilization credit at matched SLA: infeasible operating points earn
    nothing (the provider pays the violation, not the utilization)."""
    return util if feasible else 0.0


def run_drift_protocol(seed: int, *, kind: int, cfg, grid, spec,
                       tau: float, window_hours: float,
                       scenario: str = "drift_step",
                       mu_scale: float = DRIFT_MU_SCALE,
                       n_runs: int = 6, n_grid: int = 6,
                       warm_frac: float = 0.25, warm_grid: int = 5,
                       alpha: float = 0.1, n_null_reps: int = 10,
                       devices=None, device="cuda") -> DriftProtocolResult:
    """Measure the regret of drift-triggered warm re-tuning.

    Piecewise-stationary protocol:

      1. Calibrate the incumbent ``theta0`` on the stationary priors
         (``cfg.priors``) — the operating point a provider would run.
      2. Calibrate the detector null on stationary replays of ``spec`` and
         run the detector over one drifting-scenario trace; the detection
         delay (windows past the drift onset) is what the triggered arm
         pays for.
      3. Evaluate three arms on the *post-drift* regime
         (``drifted_priors(cfg.priors, mu_scale)``, fresh run keys, common
         random numbers across arms): **never** keeps theta0; **oracle**
         re-tunes cold at the onset with zero delay; **triggered** re-tunes
         on the shrunk warm grid and is credited the incumbent's
         utilization for the detection-delay fraction of the post-onset
         horizon.

    Regret is against the oracle's credited utilization (infeasible => 0
    credit). The shipped drift direction — mu down, lifetimes up — is the
    dangerous one: load grows, the stationary theta slides past the SLA,
    and never-re-tuning forfeits its credit entirely.

    Everything runs on ``device`` (the card unless the caller passes
    ``"cpu"``); ``seed`` derives four seeds (``split_seeds``): the base
    calibration's runs, the null's replays, the drifting trace and the
    post-drift runs.
    """
    from ..sim.simulator import make_run

    device = resolve_device(device)
    k0, k_null, k_trace, k_b = split_seeds(seed, 4)
    run_fn = make_run(cfg, grid, kind, device=device)
    keys0 = split_seeds(k0, n_runs)
    base = calibrate(run_fn, kind, keys0, capacity=cfg.capacity, tau=tau,
                     n_grid=n_grid, max_stages=2, devices=devices)
    theta0 = base.theta

    null = calibrate_drift_detector(k_null, spec, window_hours=window_hours,
                                    n_reps=n_null_reps, alpha=alpha,
                                    device=device)
    trace = synthesize_scenario(k_trace, scenario, spec, device=device)
    report = detect_drift(trace, null, window_hours=window_hours)

    horizon = float(spec.horizon_hours)
    onset_h = _SCENARIO_ONSET.get(scenario, lambda h: 0.0)(horizon)
    onset_window = int(onset_h / window_hours)
    if report.fired:
        # detection closes at the end of the fired window
        delay_windows = max(report.fired_window + 1 - onset_window, 0)
    else:
        delay_windows = report.n_windows - onset_window
    post_onset_h = max(horizon - onset_h, window_hours)
    delay_frac = min(max(delay_windows * window_hours / post_onset_h, 0.0),
                     1.0)

    # -- post-drift regime: three arms on common random numbers -------------
    cfg2 = cfg._replace(priors=drifted_priors(cfg.priors, mu_scale))
    run_fn2 = make_run(cfg2, grid, kind, device=device)
    keys_b = split_seeds(k_b, n_runs)

    m = eval_theta_grid(run_fn2, kind, [theta0], keys_b,
                        capacity=cfg2.capacity, devices=devices)
    fails = m.failed_requests[0].cpu().numpy()
    reqs = m.total_requests[0].cpu().numpy()
    sla_never, _, _ = sla_ci(fails, reqs)
    util_never_raw = float(np.mean(m.utilization[0].cpu().numpy()))
    feas_never = sla_never <= tau
    cred_never = _credit(util_never_raw, feas_never)

    oracle_cal = calibrate(run_fn2, kind, keys_b, capacity=cfg2.capacity,
                           tau=tau, n_grid=n_grid, max_stages=2,
                           devices=devices)
    cred_oracle = _credit(oracle_cal.utilization, oracle_cal.feasible)

    warm = retune_warm(run_fn2, kind, keys_b, capacity=cfg2.capacity,
                       tau=tau, theta0=theta0, frac=warm_frac,
                       n_grid=warm_grid, max_stages=2, escalate_grid=n_grid,
                       devices=devices)
    cred_warm = _credit(warm.utilization, warm.feasible)
    # the triggered arm runs the incumbent until detection, then the warm
    # re-tune — credited pro rata over the post-onset horizon
    util_triggered = (1.0 - delay_frac) * cred_warm + delay_frac * cred_never

    oracle = DriftArm(name="oracle", theta=oracle_cal.theta,
                      feasible=oracle_cal.feasible,
                      sla_fail=oracle_cal.sla_fail,
                      util_raw=oracle_cal.utilization, util=cred_oracle,
                      regret=0.0, n_sims=oracle_cal.n_sims)
    never = DriftArm(name="never", theta=float(theta0), feasible=feas_never,
                     sla_fail=float(sla_never), util_raw=util_never_raw,
                     util=cred_never, regret=cred_oracle - cred_never,
                     n_sims=n_runs)
    triggered = DriftArm(name="triggered", theta=warm.theta,
                         feasible=warm.feasible, sla_fail=warm.sla_fail,
                         util_raw=warm.utilization, util=util_triggered,
                         regret=cred_oracle - util_triggered,
                         n_sims=warm.n_sims)

    ur = np.asarray(oracle_cal.util_runs, np.float64)
    se = float(ur.std(ddof=1) / np.sqrt(len(ur))) if len(ur) > 1 else 0.0
    ci = (cred_oracle - 1.96 * se, cred_oracle + 1.96 * se)
    # the CI claim is about the *recovered operating point*: matching the
    # zero-delay oracle's total credit is structurally impossible whenever
    # the incumbent earns nothing during the detection delay, so the delay
    # cost lives in ``regret`` and ``within_ci`` asks whether the warm
    # re-tune's steady-state utilization is indistinguishable from the
    # oracle's
    within = cred_warm >= ci[0]

    n_sims = base.n_sims + oracle_cal.n_sims + warm.n_sims + n_runs
    log.info("drift protocol [%s kind=%d]: delay=%d windows, regret "
             "never=%.4f triggered=%.4f (oracle util %.4f)", scenario, kind,
             delay_windows, never.regret, triggered.regret, cred_oracle)
    return DriftProtocolResult(
        kind=kind, scenario=scenario, theta0=float(theta0), base=base,
        null=null, report=report, onset_window=onset_window,
        delay_windows=int(delay_windows), delay_frac=float(delay_frac),
        oracle=oracle, triggered=triggered, never=never, oracle_ci=ci,
        within_ci=bool(within), n_sims=int(n_sims))
