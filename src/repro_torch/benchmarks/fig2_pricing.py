"""Paper Fig. 2: variance-based pricing. The second moment policy (with
Def. 4's marginal heuristic) when users hold two deployment types with 5
pseudo observations each: labeled (the user declares the type, and the
provider holds that type's posterior) against unlabeled (the provider
evaluates the two types' mixture), each tuned to the SLA by
``common.tune_and_eval``. The paper: 83% against 77% utilization.

Beside the rows it prints what §8's payment rule (``core.pricing``, Eq.
(30)) charges the arrivals of the tuned batch's first run: the hourly fee
labeled (each type priced by its own posterior variance, the two types
averaged) and unlabeled (priced by the mixture's variance), as
``examples/admission_serving.py`` prices two types.

    python -m repro_torch.benchmarks.fig2_pricing --scale quick
    python -m repro_torch.benchmarks.fig2_pricing --scale tiny --device cpu

prints one CSV row a mode (as the JAX package's ``benchmarks/
fig2_pricing.py``), each beside the paper's number, and one row of fees;
``--json PATH`` writes every number to PATH.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import SECOND
from ..core.moments import MomentCurves
from ..core.pricing import mixture_moments, payment, variance_estimate
from ..device import resolve_device
from ..kernels.moment_curves.ops import moment_curves_kernel
from ..sim import MIX_LABELED, MIX_UNLABELED, draw_arrival_stream, split_seeds
from ..sim.core import candidate_rows, type_curves
from .common import SCALES, csv_row, grid_for, sim_config, tune_and_eval

N_OBS = 5
MODES = {"labeled": MIX_LABELED, "unlabeled": MIX_UNLABELED}
PAPER = {"labeled": 0.83, "unlabeled": 0.77}


def results(scale_name: str = "tiny", seed: int = 0, device="cuda") -> dict:
    """{mode name: ``tune_and_eval``'s dict}."""
    scale = SCALES[scale_name]
    return {name: tune_and_eval(
        scale, SECOND, sim_config(scale, prior_mode=mode,
                                  n_pseudo_obs=N_OBS),
        marginal=True, seed=seed, device=device)
        for name, mode in MODES.items()}


def fees(scale_name: str = "tiny", seed: int = 0, device="cuda") -> dict:
    """The payment rule on the arrivals of the tuned batch's first run (its
    seed's stream in the unlabeled mode): the mean hourly fee labeled and
    unlabeled, and the share of arrivals whose labeled fee is at most the
    unlabeled one."""
    device = resolve_device(device)
    scale = SCALES[scale_name]
    cfg = sim_config(scale, prior_mode=MIX_UNLABELED, n_pseudo_obs=N_OBS)
    grid = grid_for(scale, cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(
        split_seeds(seed, scale.n_runs)[0])
    stream = draw_arrival_stream(gen, cfg)
    valid = (torch.arange(cfg.max_arrivals, device=device)
             < stream.n_arrivals[:, None])
    c0 = stream.c0[valid]
    curves = type_curves(cfg, grid, candidate_rows(cfg, stream),
                         moment_curves_kernel)                   # [2, T, A, N]
    per_type = MomentCurves(*(x[:, valid] for x in curves))     # [2, M, N]
    var_types = variance_estimate(per_type)                       # [2, M]
    var_mix = variance_estimate(mixture_moments((0.5, 0.5), per_type))
    labeled = 0.5 * (payment(c0, var_types[0]) + payment(c0, var_types[1]))
    unlabeled = payment(c0, var_mix)
    return dict(arrivals=int(c0.shape[0]),
                labeled_fee=float(labeled.mean()),
                unlabeled_fee=float(unlabeled.mean()),
                labeled_at_most_unlabeled=float(
                    (labeled <= unlabeled).float().mean()))


def rows(res: dict, fee: dict = None) -> list:
    """Fig. 2's CSV rows from ``results`` (and ``fees``)."""
    out = []
    for name, r in res.items():
        out.append(csv_row(
            f"fig2/{name}", 1e6 * r["seconds"],
            f"util={r['utilization']:.4f}"
            f"(ci {r['ci_lo']:.4f}:{r['ci_hi']:.4f})"
            f" param={r['param']:.4g} sla={r['sla_fail']:.2e}"
            f"<=tau={r['tau']:.0e} sims={r['n_sims']}"
            f" paper={PAPER[name]:.2f}"))
    if fee is not None:
        out.append(csv_row(
            "fig2/fees", 0.0,
            f"arrivals={fee['arrivals']}"
            f" labeled_fee={fee['labeled_fee']:.4f}/h"
            f" unlabeled_fee={fee['unlabeled_fee']:.4f}/h"
            f" labeled<=unlabeled={fee['labeled_at_most_unlabeled']:.4f}"))
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
    fee = fees(args.scale, args.seed, args.device)
    wall = time.perf_counter() - t0
    for row in rows(res, fee):
        print(row, flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"scale": args.scale, "seed": args.seed,
                       "device": args.device, "wall_s": wall,
                       "modes": res, "fees": fee}, f, indent=1)


if __name__ == "__main__":
    main()
