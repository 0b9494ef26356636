"""Quickstart: the paper's admission policies in a minute.

Builds a small simulated cluster, runs the industry-baseline threshold
policy (zeroth moment) against the paper's second-moment (Cantelli) policy,
and prints the utilization gap, the paper's headline result.

    python -m repro_torch.examples.quickstart [--smoke] [--device cpu]

The port's counterpart of the JAX package's ``examples/quickstart.py``;
the runs are a batch on ``--device`` (the card by default).
"""
from __future__ import annotations

from ..core import AZURE_PRIORS, SECOND, ZEROTH, geometric_grid, make_policy
from ..sim import SimConfig, make_run, split_seeds
from . import parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    days, n_runs = (60, 2) if args.smoke else (180, 4)
    cfg = SimConfig(capacity=1_000.0, arrival_rate=0.05,
                    horizon_hours=days * 24.0, dt=24.0, max_slots=256,
                    max_arrivals=4, priors=AZURE_PRIORS)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 24)
    seeds = split_seeds(0, n_runs)

    results = {}
    for name, kind, pol in [
        ("zeroth(baseline)", ZEROTH,
         make_policy(ZEROTH, threshold=450.0, capacity=cfg.capacity)),
        ("second(paper)", SECOND,
         make_policy(SECOND, rho=0.15, capacity=cfg.capacity)),
    ]:
        run = make_run(cfg, grid, kind, device=args.device)
        m = run(seeds, pol)
        util = float(m.utilization.mean())
        fails = int(m.failed_requests.sum())
        reqs = int(m.total_requests.sum())
        results[name] = util
        print(f"{name:18s} utilization={util:.3f} "
              f"scale-out failures={fails}/{reqs}")

    gain = results["second(paper)"] / results["zeroth(baseline)"] - 1
    print(f"\nsecond-moment policy lifts utilization by {100 * gain:.0f}% "
          f"relative (paper: ~30% at full scale)")


if __name__ == "__main__":
    main()
