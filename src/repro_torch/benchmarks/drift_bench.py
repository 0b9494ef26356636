"""Drift-recalibration rows: detector operating point + the regret ledger.

Row family ``tuning/drift/<scale>/*`` (see ``repro_torch.tuning.drift``):

  * ``.../detector`` — the Monte-Carlo-calibrated CUSUM pass over one
    drifting replay: threshold at the calibrated alpha, the window it fired
    in, and the detection delay past the drift onset.
  * ``.../regret/{never,triggered,oracle}`` — the three re-tuning arms
    evaluated on the post-drift regime under common random numbers: tuned
    theta, measured SLA, raw and *credited* utilization (infeasible arms
    earn zero; the triggered arm pays the detection delay at the
    incumbent's credit), and regret against the oracle.

The drift presets run *hotter* than the headline scales (higher arrival
rate per core of capacity): the shipped drift direction (mu down →
lifetimes up → load up) must actually push the stationary-tuned operating
point past the SLA, otherwise never-re-tuning loses nothing.

    python -m repro_torch.benchmarks.drift_bench --scale quick
    python -m repro_torch.benchmarks.drift_bench --scale tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import SECOND, geometric_grid
from ..traces import TraceSpec
from ..tuning import run_drift_protocol
from .common import Scale, csv_row, sim_config

#: the paper's headline policy is the one worth re-tuning
DRIFT_KIND = SECOND

#: loaded variants of the scale presets (n_thresholds doubles as the cold
#: calibration grid; agg_refresh pinned to 1 so overridden horizons always
#: divide). tau is looser than the headline scales: the post-drift regime
#: is meant to *violate* it for the stationary theta, not be unreachable
#: for the re-tuned ones.
DRIFT_SCALES = {
    "tiny": Scale("tiny", 1_200.0, 0.15, 120 * 24.0, 24.0, 256, 4, 5,
                  24, 2e-3, agg_refresh=1),
    "quick": Scale("quick", 2_500.0, 0.3, 240 * 24.0, 12.0, 768, 8, 6,
                   32, 1e-3, agg_refresh=1),
    "full": Scale("full", 10_000.0, 1.0, 365 * 24.0, 6.0, 4096, 16, 8,
                  48, 5e-4, agg_refresh=1),
}

#: drifting-workload replay the detector watches, per scale: (spec, window
#: hours, null replays); 12 windows, drift_step onset at window 6
DRIFT_SPECS = {
    "tiny": (TraceSpec(horizon_hours=240 * 24.0, arrival_rate=0.12,
                       max_deployments=2048, max_events=8), 20 * 24.0, 6),
    "quick": (TraceSpec(horizon_hours=360 * 24.0, arrival_rate=0.2,
                        max_deployments=4096, max_events=8), 30 * 24.0, 8),
    "full": (TraceSpec(horizon_hours=360 * 24.0, arrival_rate=0.5,
                       max_deployments=16384, max_events=8), 30 * 24.0, 16),
}


def protocol(scale_name: str = "tiny", seed: int = 0, device="cuda"):
    """``run_drift_protocol`` at the preset ``scale_name``; returns
    (result, seconds)."""
    scale = DRIFT_SCALES[scale_name]
    spec, window, n_null = DRIFT_SPECS[scale_name]
    cfg = sim_config(scale, agg_refresh_steps=scale.agg_refresh)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3.0, scale.grid_points,
                          device=device)
    t0 = time.perf_counter()
    res = run_drift_protocol(
        seed, kind=DRIFT_KIND, cfg=cfg, grid=grid, spec=spec, tau=scale.tau,
        window_hours=window, n_runs=scale.n_runs, n_grid=scale.n_thresholds,
        n_null_reps=n_null, device=device)
    return res, time.perf_counter() - t0


def rows(res, seconds: float, scale_name: str) -> list:
    """The JAX package's ``tuning/drift/<scale>/*`` CSV rows."""
    us_total = seconds * 1e6
    tau = DRIFT_SCALES[scale_name].tau
    fired_w = -1 if res.report.fired_window is None else res.report.fired_window
    out = [csv_row(
        f"tuning/drift/{scale_name}/detector", us_total,
        f"fired={int(res.report.fired)} fired_window={fired_w}"
        f" onset={res.onset_window} delay={res.delay_windows}"
        f" delay_frac={res.delay_frac:.3f}"
        f" threshold={res.null.threshold:.3f} alpha={res.null.alpha:g}"
        f" windows={res.report.n_windows} scenario={res.scenario}")]
    extra = {
        "never": f" theta0={res.theta0:.6g}",
        "triggered": f" within_oracle_ci={int(res.within_ci)}",
        "oracle": (f" ci={res.oracle_ci[0]:.4f}:{res.oracle_ci[1]:.4f}"
                   f" tau={tau:.0e}"),
    }
    for arm in (res.never, res.triggered, res.oracle):
        out.append(csv_row(
            f"tuning/drift/{scale_name}/regret/{arm.name}",
            us_total * arm.n_sims / max(res.n_sims, 1),
            f"theta={arm.theta:.6g} feasible={int(arm.feasible)}"
            f" sla={arm.sla_fail:.2e} util_raw={arm.util_raw:.4f}"
            f" util={arm.util:.4f} regret={arm.regret:.4f}"
            f" sims={arm.n_sims}" + extra[arm.name]))
    return out


def summary(res, seconds: float) -> dict:
    """Every number of the rows, for ``--json``."""
    arm = lambda a: {"theta": a.theta, "feasible": a.feasible,
                     "sla_fail": a.sla_fail, "util_raw": a.util_raw,
                     "util": a.util, "regret": a.regret, "n_sims": a.n_sims}
    return {
        "seconds": seconds, "theta0": res.theta0, "fired": res.report.fired,
        "fired_window": res.report.fired_window,
        "onset_window": res.onset_window, "delay_windows": res.delay_windows,
        "delay_frac": res.delay_frac, "threshold": res.null.threshold,
        "stats": res.report.stats.tolist(), "within_ci": res.within_ci,
        "oracle_ci": list(res.oracle_ci), "n_sims": res.n_sims,
        "arms": {a.name: arm(a) for a in (res.never, res.triggered,
                                          res.oracle)}}


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    """The detector and regret rows, as the JAX package's ``run`` returns
    them."""
    return rows(*protocol(scale_name, seed, device), scale_name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=sorted(DRIFT_SCALES), default="tiny")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="write the results and the run's wall time here")
    args = ap.parse_args(argv)
    res, seconds = protocol(args.scale, args.seed, args.device)
    for row in rows(res, seconds, args.scale):
        print(row, flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"scale": args.scale, "seed": args.seed,
                       "device": args.device,
                       "protocol": summary(res, seconds)}, f, indent=1)


if __name__ == "__main__":
    main()
