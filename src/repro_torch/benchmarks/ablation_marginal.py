"""Paper Appendix E (Fig. 9): the marginal-heuristic ablation. The second
moment policy with and without Def. 4 at 5 and 50 pseudo observations,
each tuned to the SLA by ``common.tune_and_eval``. The paper: more than 3%
utilization gained from the heuristic with good priors, none at 0
observations.

    python -m repro_torch.benchmarks.ablation_marginal --scale quick
    python -m repro_torch.benchmarks.ablation_marginal --scale tiny --device cpu

prints one CSV row a (level, heuristic) (as the JAX package's
``benchmarks/ablation_marginal.py``) and the heuristic's gain at each
level; ``--json PATH`` writes every number of the rows to PATH.
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import SECOND
from ..sim import PSEUDO
from .common import SCALES, csv_row, sim_config, tune_and_eval


def results(scale_name: str = "tiny", seed: int = 0,
            device="cuda") -> dict:
    """{(observations, marginal): ``tune_and_eval``'s dict}; the run seed
    is ``seed + observations``, as the JAX package's driver has it."""
    scale = SCALES[scale_name]
    out = {}
    for n_obs in (5,) if scale_name == "tiny" else (5, 50):
        cfg = sim_config(scale, prior_mode=PSEUDO, n_pseudo_obs=n_obs)
        for marginal in (True, False):
            out[n_obs, marginal] = tune_and_eval(
                scale, SECOND, cfg, marginal=marginal, seed=seed + n_obs,
                device=device)
    return out


def rows(res: dict) -> list:
    """The ablation's CSV rows from ``results``."""
    out = []
    for (n_obs, marginal), r in res.items():
        gain = ""
        if marginal and (n_obs, False) in res:
            base = res[n_obs, False]["utilization"]
            gain = f" gain={100 * (r['utilization'] / base - 1.0):+.1f}%"
        out.append(csv_row(
            f"ablation_marginal/obs{n_obs}_"
            f"{'with' if marginal else 'without'}", 1e6 * r["seconds"],
            f"util={r['utilization']:.4f}"
            f"(ci {r['ci_lo']:.4f}:{r['ci_hi']:.4f})"
            f" param={r['param']:.4g} sla={r['sla_fail']:.2e}"
            f"<=tau={r['tau']:.0e} sims={r['n_sims']}{gain}"))
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
                       "rows": {f"obs{n}_{'with' if m else 'without'}": r
                                for (n, m), r in res.items()}}, f, indent=1)


if __name__ == "__main__":
    main()
