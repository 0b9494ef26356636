"""Drift-aware recalibration, end to end (paper §5.2's "re-tune whenever
the environment changes", made operational).

Four stages, each printing what it measured:

  1. **Streaming prior fits**: window a trace with ``traces.window_stats``,
     merge the windows, and show that the merged fit is the batch fit (the
     sufficient-statistics layer is exact).
  2. **Calibrated drift detection**: Monte-Carlo-calibrate the CUSUM null
     on stationary replays, then watch the detector fire on a mid-trace
     lifetime drift (``drift_step``: mean lifetimes jump 2.5x).
  3. **Live detector**: the same detector riding the online admission
     engine's telemetry; every ``metrics_snapshot()`` scrape is one
     detector window.
  4. **Regret of re-tuning**: the never / triggered-warm / oracle arms on
     the post-drift regime: what the detector and a warm re-tune buy.

    python -m repro_torch.examples.drift_recalibration [--smoke] \
        [--device cpu]

The port's counterpart of the JAX package's
``examples/drift_recalibration.py``, on ``--device`` (the card by
default).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import SECOND, geometric_grid, make_policy
from ..sim import make_config
from ..traces import (TraceSpec, fit_priors, merge_stats, stats_to_priors,
                      synthesize_scenario, window_stats)
from ..tuning import (DriftDetector, DriftNull, calibrate_drift_detector,
                      channels_from_obs, detect_drift, run_drift_protocol)
from . import parse_args

SPEC = TraceSpec(horizon_hours=240 * 24.0, arrival_rate=0.12,
                 max_deployments=2048, max_events=8)
WINDOW = 20 * 24.0   # 12 windows; drift_step's onset at window 6


def streaming_fit(device):
    print("== 1. streaming prior fit ==")
    trace = synthesize_scenario(3, "baseline", SPEC, device=device)
    edges = np.linspace(0.0, float(SPEC.horizon_hours), 5)
    windows = [window_stats(trace, a, b)
               for a, b in zip(edges[:-1], edges[1:])]
    merged, _ = stats_to_priors(merge_stats(*windows))
    batch, _ = fit_priors(trace, source="observed")
    print(f"  4 windows merged:  mu=({merged.mu_shape:.4f}, "
          f"{merged.mu_rate:.4f}) nu={merged.nu:.2f}")
    print(f"  whole-trace batch: mu=({batch.mu_shape:.4f}, "
          f"{batch.mu_rate:.4f}) nu={batch.nu:.2f}")
    return trace


def offline_detection(device, smoke: bool):
    print("== 2. calibrated drift detection ==")
    null = calibrate_drift_detector(7, SPEC, window_hours=WINDOW,
                                    n_reps=4 if smoke else 8, alpha=0.1,
                                    device=device)
    print(f"  null: threshold={null.threshold:.2f} (alpha={null.alpha}, "
          f"{null.n_reps} stationary replays)")
    for scen in ("baseline", "drift_step"):
        tr = synthesize_scenario(11, scen, SPEC, device=device)
        rep = detect_drift(tr, null, window_hours=WINDOW)
        tail = " ".join(f"{s:.1f}" for s in rep.stats)
        print(f"  {scen:11s}: fired={rep.fired} window={rep.fired_window} "
              f"stats=[{tail}]")
    return null


def live_detector(device):
    print("== 3. detector riding the online engine ==")
    from ..serve import Arrival, OnlineAdmissionEngine

    cfg = make_config(capacity=300.0, arrival_rate=0.1,
                      horizon_hours=8 * 24.0, dt=24.0, max_slots=64,
                      max_arrivals=4, telemetry=True)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 12)
    pol = make_policy(SECOND, rho=0.3, capacity=cfg.capacity)

    # live channels are time-sliced telemetry ratio rates, on another scale
    # than the offline per-deployment means: a live deployment calibrates
    # its null on stationary scrape replays. For the demo a rough null is
    # seeded from the first scrape of a warm-up engine, and the statistic
    # is watched under steady load.
    warm = OnlineAdmissionEngine(cfg, grid, SECOND, pol, device=device)
    gen = torch.Generator(device=warm.device).manual_seed(1)
    warm.tick(gen=gen)
    mean = channels_from_obs(warm.metrics_snapshot()["telemetry"]["obs"])
    null = DriftNull(
        mean=mean,
        std={c: max(abs(v), 1e-3) for c, v in mean.items()},
        threshold=8.0, alpha=0.1, slack=0.5, n_reps=1, n_windows=1)

    eng = OnlineAdmissionEngine(cfg, grid, SECOND, pol,
                                drift_detector=DriftDetector(null),
                                device=device)
    for _ in range(cfg.n_steps):
        eng.tick(gen=gen)
        eng.submit(Arrival.draw(gen, cfg))
        eng.flush()
        d = eng.metrics_snapshot()["drift"]   # one scrape = one window
    print(f"  after {d['n_windows']} scrapes: stat={d['stat']:.2f} "
          f"threshold={d['threshold']:.2f} fired={bool(d['fired'])}")


def regret(device, smoke: bool):
    print("== 4. regret of re-tuning (never / triggered / oracle) ==")
    # hot enough that the 2.5x post-drift load pushes the stationary theta
    # past the SLA: never re-tuning must lose its credit here
    cfg = make_config(capacity=800.0, arrival_rate=0.08,
                      horizon_hours=60 * 24.0, dt=24.0, max_slots=128,
                      max_arrivals=5, agg_refresh_steps=1)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3.0, 16)
    res = run_drift_protocol(
        0, kind=SECOND, cfg=cfg, grid=grid, spec=SPEC, tau=5e-3,
        window_hours=WINDOW, n_runs=3 if smoke else 4,
        n_grid=4 if smoke else 5, n_null_reps=4 if smoke else 8,
        device=device)
    print(f"  detector: fired_window={res.report.fired_window} "
          f"(onset {res.onset_window}, delay {res.delay_windows} windows)")
    for arm in (res.never, res.triggered, res.oracle):
        print(f"  {arm.name:9s}: theta={arm.theta:.4g} "
              f"feasible={arm.feasible} sla={arm.sla_fail:.1e} "
              f"credited_util={arm.util:.4f} regret={arm.regret:.4f}")
    print(f"  triggered within oracle CI "
          f"[{res.oracle_ci[0]:.4f}, {res.oracle_ci[1]:.4f}]: "
          f"{res.within_ci}")


def main(argv=None):
    args = parse_args(__doc__, argv)
    streaming_fit(args.device)
    offline_detection(args.device, args.smoke)
    live_detector(args.device)
    regret(args.device, args.smoke)


if __name__ == "__main__":
    main()
