"""Calibration in a minute: tune a policy to the SLA, re-tune per scenario.

Three short acts:

  1. calibrate the second-moment policy's Cantelli rho to an SLA target
     with ``repro_torch.tuning.calibrate``: the whole candidate grid in one
     batched run, CI-aware stopping;
  2. re-tune the same policy against a flash-crowd scenario's own replayed
     arrivals and print the robustness gap (stationary-tuned against
     re-tuned utilization at matched SLA);
  3. read the agg_refresh K-curve selection the benchmarks consume
     (``pick_agg_refresh`` over the BENCH file).

    python -m repro_torch.examples.calibrate_policy [--smoke] [--device cpu]

The port's counterpart of the JAX package's
``examples/calibrate_policy.py``, on ``--device`` (the card by default).
``pick_agg_refresh`` reads ``$REPRO_BENCH_JSON`` when it is set, else the
JAX package's ``BENCH_<scale>.json``.
"""
from __future__ import annotations

from ..core import SECOND, geometric_grid
from ..sim import make_config, make_run, split_seeds
from ..traces import TraceSpec
from ..tuning import (calibrate, calibrate_scenario, pick_agg_refresh,
                      replay_stream_batch)
from . import parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    days, n_runs, n_grid = (30, 2, 4) if args.smoke else (120, 4, 6)
    tau = 5e-3
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=days * 24.0, dt=24.0, max_slots=128,
                      max_arrivals=4, d_points=8)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 12)
    run_fn = make_run(cfg, grid, SECOND, device=args.device)
    seeds = split_seeds(0, n_runs)

    # 1. calibrate to the SLA: one batched run a stage, stop on the CI
    res = calibrate(run_fn, SECOND, seeds, capacity=cfg.capacity, tau=tau,
                    n_grid=n_grid, max_stages=2)
    print(f"calibrated rho={res.theta:.4g} util={res.utilization:.3f} "
          f"sla={res.sla_fail:.1e} (ci {res.sla_lo:.1e}..{res.sla_hi:.1e}) "
          f"<= tau={tau:.0e} [{len(res.stages)} stage(s), {res.n_sims} sims]")

    # 2. the same policy under a flash crowd: robustness against re-tuned
    replay_cfg = cfg._replace(max_arrivals=8)
    spec = TraceSpec(horizon_hours=cfg.horizon_hours,
                     arrival_rate=cfg.arrival_rate,
                     max_deployments=256, max_events=8)
    streams, run_seeds, _ = replay_stream_batch(
        1, 2, "flash_crowd", spec, replay_cfg, n_runs, device=args.device)
    cal = calibrate_scenario(
        make_run(replay_cfg, grid, SECOND, device=args.device), SECOND,
        "flash_crowd", streams, run_seeds, capacity=cfg.capacity, tau=tau,
        stationary_theta=res.theta, n_grid=n_grid, max_stages=1)
    print(f"flash_crowd: stationary-tuned util={cal.stationary_util:.3f} "
          f"(sla={cal.stationary_sla:.1e}) -> re-tuned "
          f"util={cal.retuned.utilization:.3f} "
          f"(rho={cal.retuned.theta:.4g}, sla={cal.retuned.sla_fail:.1e}); "
          f"gap={cal.util_gap:+.3f}")

    # 3. per-scale agg_refresh from the measured K-curve (the hand-picked
    # value is only the fallback when no curve is recorded for the scale)
    for scale, hand in (("tiny", 4), ("quick", 8), ("full", 12)):
        recorded = pick_agg_refresh(scale, fallback=-1) != -1
        k = pick_agg_refresh(scale, fallback=hand)
        src = "measured K-curve" if recorded else "hand-picked fallback"
        print(f"agg_refresh[{scale}] = {k}  ({src})")


if __name__ == "__main__":
    main()
