#!/usr/bin/env python3
"""The port's single simulator run on one CUDA card, for one or more
checkouts of the port, in turns.

    python3 tools/torch_run_ab.py [--roots A B] [--order ABBA] [--out DIR]

Each turn is one process that imports ``repro_torch`` from ``ROOT/src`` of
one checkout (building its kernels into that checkout's ``build/``) and
runs ``chip_smoke.py`` phase 4's SECOND run: ``make_run`` at PAPER_FULL
(the ``full`` preset's 48-point grid, aggregate refresh every 12 steps),
rho 0.112, seed 2018, twice, timing each run's wall (steps/s) and printing
its metrics; then the one-run aggregate kernel's device time at D = 8,192,
N = 48, ND = 24 (``chip_smoke.graph_ms``, a CUDA graph of 50 calls, median
of 7 replays); then the checkout's own ``tools/torch_step_profile.py`` (one
run: CUDA kernels a step, host ms a step, device idle share). Turns run in
the order given (A B B A by default), so two versions are compared on one
card in one call. Prints one JSON object a turn and the card's name and
power limit; with ``--out``, the profiles go to DIR as well.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def turn(root: str) -> dict:
    sys.path.insert(0, str(Path(root) / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import belief_case, graph_ms
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import AZURE_PRIORS, SECOND, geometric_grid
    from repro_torch.core import make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import make_run

    out = {"root": root}
    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 48, device="cuda")
    run = make_run(cfg, grid, SECOND, device="cuda")
    policy = make_policy(SECOND, rho=PAPER_TABLE2["second_rho"],
                         capacity=cfg.capacity)
    out["steps_per_s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run(2018, policy)
        torch.cuda.synchronize()
        out["steps_per_s"].append(cfg.n_steps / (time.perf_counter() - t0))
    out["metrics"] = {name: float(getattr(m, name)) for name in
                      ("utilization", "failure_rate", "arrivals_accepted",
                       "arrivals_rejected", "total_requests")}
    bel, cores, alive, _, (t, idx, frac, _) = belief_case(8192, 48, 24, 11,
                                                          "cuda")
    out["agg_device_ms"] = graph_ms(lambda: K.moment_curves_agg_belief(
        bel, cores, alive, t, idx, frac, 24, AZURE_PRIORS))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(ROOT)],
                    help="checkouts, named A, B, ... in --order")
    ap.add_argument("--order", default=None,
                    help="turns by letter; default ABBA (A with one root)")
    ap.add_argument("--out", default=None,
                    help="directory for each turn's step profile")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_run_ab: needs a CUDA card")
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return
    order = args.order or ("A" if len(args.roots) == 1 else "ABBA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for i, letter in enumerate(order):
        root = args.roots[ord(letter) - ord("A")]
        res = subprocess.run([sys.executable, __file__, "--turn", root],
                             check=True, capture_output=True, text=True)
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        prof = subprocess.run(
            [sys.executable, str(Path(root) / "tools" /
                                 "torch_step_profile.py")],
            check=True, capture_output=True, text=True).stdout
        prof = json.loads(prof[prof.index("{"):])
        if args.out:
            Path(args.out).mkdir(parents=True, exist_ok=True)
            (Path(args.out) / f"profile_{i + 1}_{letter}.json").write_text(
                json.dumps(prof, indent=1))
        rec.update(turn_no=i + 1, letter=letter, profile={
            k: prof.get(k) for k in ("wall_ms_per_step",
                                     "cuda_kernels_per_step",
                                     "device_busy_ms_per_step",
                                     "device_idle_share")})
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
