#!/usr/bin/env python3
"""Where a simulator step's time goes on the card, for the PyTorch port.

Runs the port's SECOND admission core at PAPER_FULL (the ``full`` preset's
48-point grid, aggregate refresh every 12 steps) on one CUDA card, for one
run or (``--runs R``) a batch of R runs stepped together as ``make_run``
steps a batch (a leading run axis; each run's events from its own
generator), warms the slot tables up for ``--warm`` steps, then profiles
``--steps`` more with ``torch.profiler`` and prints one JSON object: host
wall time per step, runs x steps/s, CUDA kernels launched per step, device
busy time per step, the device's idle share, and the kernels taking the
most device time. ``--prior-mode pseudo|labeled|unlabeled`` with
``--n-pseudo-obs K`` profiles the §6/§7 prior modes, ``--marginal`` adds
Def. 4's heuristic to the policy (as the figures' drivers run it).

    python3 tools/torch_step_profile.py [--warm 2000] [--steps 48] [--runs 24]
        [--prior-mode unlabeled --n-pseudo-obs 5 --marginal]
"""
import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--runs", type=int, default=1,
                    help="runs stepped together (1: a single run; seeds "
                         "from split_seeds(2018, R) otherwise)")
    ap.add_argument("--prior-mode", default="global",
                    choices=("global", "pseudo", "labeled", "unlabeled"))
    ap.add_argument("--n-pseudo-obs", type=int, default=0)
    ap.add_argument("--marginal", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import PAPER_FULL
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.sim import (draw_arrival_stream, make_admission_core,
                                 split_seeds)
    from repro_torch.sim.simulator import _accumulate_step, _steps, _tree_map

    cfg = PAPER_FULL._replace(agg_refresh_steps=12,
                              prior_mode=args.prior_mode,
                              n_pseudo_obs=args.n_pseudo_obs)
    if args.warm + args.steps > cfg.n_steps:
        sys.exit(f"--warm + --steps exceeds the run's {cfg.n_steps} steps")
    dev = torch.device("cuda")
    core = make_admission_core(
        cfg, geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 48), SECOND,
        device=dev)
    policy = make_policy(SECOND, rho=0.112, capacity=cfg.capacity,
                         marginal=args.marginal, device=dev)
    if args.runs == 1:
        runs, gen = None, torch.Generator(device=dev).manual_seed(2018)
        stream = draw_arrival_stream(gen, cfg)
    else:
        runs = args.runs
        gen = [torch.Generator(device=dev).manual_seed(s)
               for s in split_seeds(2018, runs)]
        stream = _tree_map(lambda *xs: torch.stack(xs, dim=1),
                           *(draw_arrival_stream(g, cfg) for g in gen))
    # as make_run: the candidates' rows once a run, a step's are views
    steps, rows = _steps(stream), _steps(core.candidate_rows(stream))
    arange_a = torch.arange(cfg.max_arrivals, device=dev)
    state = [core.init(runs)]

    def step(t):
        cs = state[0]
        if t % cfg.agg_refresh_steps == 0:
            cs = core.refresh_aggregates(cs)
        cs, out = core.apply_events(gen, cs)
        st = steps[t]
        valid = arange_a < st.n_arrivals[..., None]
        cs, accept = core.decide_batch(policy, cs, out.util,
                                       core.candidates(rows[t]), st, valid)
        n_acc = torch.sum(accept.float(), dim=-1)
        slots, _ = _accumulate_step(
            cs.slots, out, n_acc, torch.sum(valid.float(), dim=-1) - n_acc,
            cfg.dt)
        state[0] = cs._replace(slots=slots)

    for t in range(args.warm):
        step(t)
    torch.cuda.synchronize()
    window = range(args.warm, args.warm + args.steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in window:
            step(t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    n = args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": card,
        "config": "PAPER_FULL, SECOND rho 0.112, agg_refresh_steps 12, N 48",
        "prior_mode": args.prior_mode, "n_pseudo_obs": args.n_pseudo_obs,
        "marginal": args.marginal,
        "runs": args.runs, "warm_steps": args.warm, "steps": n,
        "occupied_slots_per_run": float(state[0].slots.alive.sum())
        / args.runs,
        "wall_ms_per_step": 1e3 * wall / n,
        "runs_x_steps_per_s": args.runs * n / wall,
        "cuda_kernels_per_step": len(kernels) / n,
        "device_busy_ms_per_step": (1e-3 * busy_us / n) if kernels else None,
        "device_idle_share": (1.0 - 1e-6 * busy_us / wall) if kernels
        else None,
        "top_kernels": [{"name": k[:90], "count_per_step": v[0] / n,
                         "us_per_step": v[1] / n} for k, v in top],
    }, indent=1))


if __name__ == "__main__":
    main()
