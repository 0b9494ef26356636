"""Paper Fig. 1: the value of deployment-specific priors. The first and
second moment policies (with Def. 4's marginal heuristic) at 0, 1, 5 and 50
pseudo observations of each arrival's own processes, each policy's
parameter tuned to the SLA by ``common.tune_and_eval``. 0 observations is
the global-prior baseline. The paper: one observation lifts the second
moment policy's utilization to ~79.5%, 50 to ~83.8%.

    python -m repro_torch.benchmarks.fig1_priors --scale quick
    python -m repro_torch.benchmarks.fig1_priors --scale tiny --device cpu

prints one CSV row a (policy, level) (as the JAX package's
``benchmarks/fig1_priors.py``), each beside the paper's number where it
gives one; ``--json PATH`` writes every number of the rows to PATH.
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import FIRST, SECOND
from ..sim import GLOBAL, PSEUDO
from .common import SCALES, csv_row, sim_config, tune_and_eval

OBS_LEVELS = (0, 1, 5, 50)
KINDS = {"first": FIRST, "second": SECOND}
#: the paper's utilizations where it states them (§6; 0 observations is
#: Table 2's second moment policy)
PAPER = {("second", 0): 0.6732, ("second", 1): 0.795, ("second", 50): 0.838}


def results(scale_name: str = "tiny", seed: int = 0,
            device="cuda") -> dict:
    """{(policy name, observations): ``tune_and_eval``'s dict}; the run
    seed is ``seed + observations``, as the JAX package's driver has it."""
    scale = SCALES[scale_name]
    # the CPU preset trims the costliest level
    obs_levels = (0, 1, 5) if scale_name == "tiny" else OBS_LEVELS
    out = {}
    for name in KINDS:
        for n_obs in obs_levels:
            mode = PSEUDO if n_obs > 0 else GLOBAL
            cfg = sim_config(scale, prior_mode=mode, n_pseudo_obs=n_obs)
            out[name, n_obs] = tune_and_eval(scale, KINDS[name], cfg,
                                             marginal=True,
                                             seed=seed + n_obs,
                                             device=device)
    return out


def rows(res: dict) -> list:
    """Fig. 1's CSV rows from ``results``."""
    out = []
    for (name, n_obs), r in res.items():
        paper = PAPER.get((name, n_obs))
        out.append(csv_row(
            f"fig1/{name}_obs{n_obs}", 1e6 * r["seconds"],
            f"util={r['utilization']:.4f}"
            f"(ci {r['ci_lo']:.4f}:{r['ci_hi']:.4f})"
            f" param={r['param']:.4g} sla={r['sla_fail']:.2e}"
            f"<=tau={r['tau']:.0e} sims={r['n_sims']}"
            + (f" paper={paper:.4f}" if paper is not None else "")))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=sorted(SCALES), default="tiny")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="write the results and the run's wall time here")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = results(args.scale, args.seed, args.device)
    wall = time.perf_counter() - t0
    for row in rows(res):
        print(row, flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"scale": args.scale, "seed": args.seed,
                       "device": args.device, "wall_s": wall,
                       "rows": {f"{k}_obs{n}": r
                                for (k, n), r in res.items()}}, f, indent=1)


if __name__ == "__main__":
    main()
