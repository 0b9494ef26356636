"""Trace-driven workloads in a minute: generate -> fit -> replay -> ingest.

Four short acts:

  1. synthesize an Azure-like workload trace from the paper's Table-1
     priors and refit the priors from it (the generate -> fit loop);
  2. replay two scenarios, the stationary baseline and a flash crowd,
     through the same admission policy via the simulator's pluggable
     ArrivalSource;
  3. replay the same trace under a richer information model (§6 pseudo
     observations against the GLOBAL prior): the same arrivals, better
     beliefs;
  4. ingest a real Cortez/Azure-format VM table (the checked-in sample,
     ``tests/data/azure_cortez_sample.csv``), fit priors from its
     observables, and replay it.

    python -m repro_torch.examples.trace_scenarios [--smoke] [--device cpu]

The port's counterpart of the JAX package's
``examples/trace_scenarios.py``, on ``--device`` (the card by default).
"""
from __future__ import annotations

import os

from ..core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from ..sim import PSEUDO, make_config, make_run, split_seeds
from ..traces import (TraceArrivalSource, TraceSpec, fit_priors,
                      ingest_cortez_csv, n_deployments, prior_relative_errors,
                      synthesize_scenario)
from . import parse_args

SAMPLE_CSV = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "tests", "data", "azure_cortez_sample.csv")


def main(argv=None):
    args = parse_args(__doc__, argv)
    device = args.device
    days = 90 if args.smoke else 180
    n_runs = 2 if args.smoke else 4
    cfg = make_config(capacity=1_000.0, arrival_rate=0.05,
                      horizon_hours=days * 24.0, dt=24.0, max_slots=256,
                      max_arrivals=8)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 24)
    spec = TraceSpec(horizon_hours=cfg.horizon_hours,
                     arrival_rate=cfg.arrival_rate,
                     max_deployments=1024, max_events=8)
    pol = make_policy(SECOND, rho=0.15, capacity=cfg.capacity)
    seeds = split_seeds(2, n_runs)

    # 1. generate -> fit: recover Table 1 from a synthetic trace
    fit_spec = spec._replace(arrival_rate=0.25 if args.smoke else 0.5,
                             max_deployments=4096 if args.smoke else 8192)
    trace = synthesize_scenario(0, "baseline", fit_spec, device=device)
    fitted, _ = fit_priors(trace, source="latent")
    errs = prior_relative_errors(fitted, AZURE_PRIORS)
    print(f"fit round-trip on {n_deployments(trace)} deployments: "
          f"max relative error {max(errs.values()):.1%} "
          f"(nu {fitted.nu:.3f} vs {AZURE_PRIORS.nu})")

    # 2. replay scenarios through one policy
    for scen in ("baseline", "flash_crowd"):
        tr = synthesize_scenario(1, scen, spec, device=device)
        run = make_run(cfg, grid, SECOND,
                       arrival_source=TraceArrivalSource(tr), device=device)
        m = run(seeds, pol)
        print(f"{scen:12s} utilization={float(m.utilization.mean()):.3f} "
              f"failures={int(m.failed_requests.sum())}"
              f"/{int(m.total_requests.sum())}")

    # 3. the same arrivals, richer information: GLOBAL against §6 pseudo
    # observations
    tr = synthesize_scenario(1, "baseline", spec, device=device)
    for label, mode_cfg in (
            ("global", cfg),
            ("pseudo(k=5)", cfg._replace(prior_mode=PSEUDO, n_pseudo_obs=5))):
        run = make_run(mode_cfg, grid, SECOND,
                       arrival_source=TraceArrivalSource(tr), device=device)
        m = run(seeds, pol)
        print(f"info {label:12s} utilization="
              f"{float(m.utilization.mean()):.3f}")

    # 4. real data: ingest the Cortez-format sample, fit, replay
    real, diag = ingest_cortez_csv(SAMPLE_CSV, device=device)
    real_fit, _ = fit_priors(real, source="observed")
    print(f"ingested {diag['n_vms']} VM rows -> "
          f"{diag['n_deployments']} deployments "
          f"({diag['n_malformed']} malformed), "
          f"horizon {diag['horizon_hours']:.0f}h; "
          f"fitted E[mu]={real_fit.mu_shape / real_fit.mu_rate:.4f}/h")
    horizon = float(real.horizon_hours)
    n_steps = max(int(horizon // 24.0), 1)
    # n_pseudo_obs is ignored by observed-trace replay (the logged history
    # defines the information); >= 1 satisfies the PSEUDO validation
    real_cfg = make_config(capacity=200.0, arrival_rate=0.05,
                           horizon_hours=n_steps * 24.0, dt=24.0,
                           max_slots=64, max_arrivals=8, d_points=8,
                           prior_mode=PSEUDO, n_pseudo_obs=1)
    real_run = make_run(real_cfg, geometric_grid(24.0, 3 * horizon, 16),
                        SECOND, arrival_source=TraceArrivalSource(real),
                        device=device)
    real_pol = make_policy(SECOND, rho=0.15, capacity=real_cfg.capacity)
    m = real_run(3, real_pol)
    print(f"real-trace replay (observed pseudo beliefs): "
          f"utilization={float(m.utilization):.3f}")


if __name__ == "__main__":
    main()
