"""Paper Table 2: zeroth vs first vs second moment policy utilization, each
policy's parameter tuned to the SLA by ``repro_torch.tuning.calibrate``
(one batched run a stage, CI-aware stopping) through
``common.tune_and_eval``, with 95% BCa CIs. The paper's values at full
scale: 50.45% / 66.19% / 67.32% (+31.2% / +33.4% relative).

    python -m repro_torch.benchmarks.table2_policies --scale quick
    python -m repro_torch.benchmarks.table2_policies --scale tiny --device cpu

prints one CSV row a policy (as the JAX package's ``table2_policies``) and,
with ``--json PATH``, writes every number of the rows to PATH.
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import FIRST, SECOND, ZEROTH
from .common import SCALES, csv_row, sim_config, tune_and_eval

NAMES = {ZEROTH: "zeroth", FIRST: "first", SECOND: "second"}


def results(scale_name: str = "tiny", seed: int = 0,
            device="cuda") -> dict:
    """{policy name: ``tune_and_eval``'s dict} for the three policies."""
    scale = SCALES[scale_name]
    cfg = sim_config(scale)
    return {NAMES[kind]: tune_and_eval(scale, kind, cfg, seed=seed,
                                       device=device)
            for kind in (ZEROTH, FIRST, SECOND)}


def rows(res: dict) -> list:
    """Table 2's CSV rows from ``results``."""
    out = []
    for name, r in res.items():
        rel = ""
        if name != "zeroth" and res["zeroth"]["utilization"] > 0:
            gain = r["utilization"] / res["zeroth"]["utilization"] - 1.0
            rel = f"+{100 * gain:.1f}%_vs_zeroth"
        out.append(csv_row(
            f"table2/{name}", 1e6 * r["seconds"],
            f"util={r['utilization']:.4f}"
            f"(ci {r['ci_lo']:.4f}:{r['ci_hi']:.4f})"
            f" param={r['param']:.4g} sla={r['sla_fail']:.2e}"
            f"<=tau={r['tau']:.0e} stages={len(r['stages'])}"
            f" sims={r['n_sims']} {rel}"))
    return out


def run(scale_name: str = "tiny", seed: int = 0,
        device="cuda") -> list:
    """Table 2's CSV rows, as the JAX package's ``run`` returns them."""
    return rows(results(scale_name, seed, device))


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
                       "policies": res}, f, indent=1)


if __name__ == "__main__":
    main()
