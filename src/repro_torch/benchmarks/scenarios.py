"""Scenario × policy sweep over synthetic traces: robustness *and* the cost
of honoring the SLA.

For every registered trace scenario (diurnal modulation, flash crowds,
heavy-tail lifetime inflation, correlated batches, prior drift) and every
policy kind, two operating points run on the **same** replay streams and
run seeds:

  * *stationary-tuned* — parameters fixed at the stationary regime's values
    (the paper's full-scale Table-2 tuned values as capacity fractions): how
    robust is a policy to non-stationary arrivals it was never tuned for?
  * *re-tuned* — ``tuning.calibrate_scenario`` re-calibrates the parameter
    against the scenario's own arrivals at the matched scale-adjusted SLA.

Both land in one row per (scenario, kind). Also reports the generate→fit
prior round-trip error, an information-model comparison (one baseline
trace ensemble replayed under GLOBAL / §6 PSEUDO / §7 labeled beliefs
through the trace-level stratified importance plan), and the seed-level
importance plan simulated in one batch.

    python -m repro_torch.benchmarks.scenarios --scale quick
    python -m repro_torch.benchmarks.scenarios --scale tiny --device cpu

prints the JAX package's ``scenarios/*`` rows (its fleet rows are
``fleet_bench``'s) and, with ``--json PATH``, writes every number of the
rows to PATH. Seeds come from ``sim.split_seeds`` and
``(seed, n)``-derived words where the JAX package folds keys, so the two
packages draw different traces and runs.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import AZURE_PRIORS, FIRST, SECOND, ZEROTH, make_policy
from ..sim import (GLOBAL, MIX_LABELED, PSEUDO, estimate_from_plan,
                   make_importance_plan, make_run, make_trace_ensemble_plan,
                   simulate_plan, simulate_trace_plan, split_seeds)
from ..sim.simulator import _seed_word
from ..traces import (TraceSpec, fit_priors, prior_relative_errors,
                      scenario_names, synthesize_scenario, trace_to_stream)
from ..tuning import calibrate_scenario, replay_stream_batch
from .common import SCALES, csv_row, grid_for, sim_config

NAMES = {ZEROTH: "zeroth", FIRST: "first", SECOND: "second"}

#: replay caps per-step arrivals well above the prior-sampled preset so that
#: flash-crowd bursts stress the *policy*, not the columnar buffer
REPLAY_MAX_ARRIVALS = 16

#: stationary-regime policy parameters as fractions of capacity (zeroth and
#: first thresholds) / the Cantelli rho, from the paper's full-scale tuned
#: Table-2 values (8864/20000, 14223/20000, 0.112)
PAPER_RATIO_PARAMS = {ZEROTH: 8864.0 / 20000.0, FIRST: 14223.0 / 20000.0,
                      SECOND: 0.112}


def trace_spec_for(cfg) -> TraceSpec:
    """A trace spec matching a preset: its horizon and arrival rate, the
    capacity twice the expected arrivals rounded up to a power of two."""
    expected = cfg.arrival_rate * cfg.horizon_hours
    cap = 1 << max(int(np.ceil(np.log2(max(expected * 2.0, 64.0)))), 6)
    return TraceSpec(horizon_hours=cfg.horizon_hours,
                     arrival_rate=cfg.arrival_rate,
                     max_deployments=int(cap), max_events=16,
                     priors=AZURE_PRIORS)


def results(scale_name: str = "tiny", seed: int = 0, device="cuda") -> dict:
    """{row name: its numbers} of the sweep at the preset ``scale_name``."""
    scale = SCALES[scale_name]
    cfg = sim_config(scale)
    grid = grid_for(scale, cfg, device=device)
    spec = trace_spec_for(cfg)
    out = {}

    # -- generate -> fit -> Table-1 round-trip ------------------------------
    big = spec._replace(max_deployments=max(spec.max_deployments, 8192),
                        arrival_rate=max(
                            spec.arrival_rate,
                            8192.0 / (2.0 * spec.horizon_hours)))
    trace = synthesize_scenario(seed, "baseline", big, device=device)
    for source in ("latent", "observed"):
        t0 = time.perf_counter()
        fitted, _ = fit_priors(trace, source=source)
        errs = prior_relative_errors(fitted, AZURE_PRIORS)
        worst = max(errs, key=errs.get)
        out[f"fit_roundtrip_{source}"] = {
            "max_relerr": errs[worst], "worst": worst, "nu": fitted.nu,
            "delta": fitted.delta, "relerr": errs,
            "seconds": time.perf_counter() - t0}

    # -- fixed stationary-regime policy parameters ---------------------------
    tuned = {ZEROTH: PAPER_RATIO_PARAMS[ZEROTH] * cfg.capacity,
             FIRST: PAPER_RATIO_PARAMS[FIRST] * cfg.capacity,
             SECOND: PAPER_RATIO_PARAMS[SECOND]}

    # -- replay every scenario: stationary-tuned vs re-tuned at matched SLA --
    replay_cfg = cfg._replace(max_arrivals=REPLAY_MAX_ARRIVALS)
    runs = {kind: make_run(replay_cfg, grid, kind, device=device)
            for kind in (ZEROTH, FIRST, SECOND)}
    base_util = {}
    for si, scen in enumerate(scenario_names()):
        # trace seeds and run seeds from distinct roots
        streams, run_seeds, dropped = replay_stream_batch(
            _seed_word(seed, 100 + si), _seed_word(seed, 500 + si),
            scen, spec, replay_cfg, scale.n_runs, device=device)
        for kind in (ZEROTH, FIRST, SECOND):
            t0 = time.perf_counter()
            cal = calibrate_scenario(
                runs[kind], kind, scen, streams, run_seeds,
                capacity=replay_cfg.capacity, tau=scale.tau,
                stationary_theta=tuned[kind],
                n_grid=scale.n_thresholds, max_stages=1)
            if scen == "baseline":
                base_util[kind] = cal.stationary_util
            rel = (cal.stationary_util / base_util[kind] - 1.0
                   if scen != "baseline" and base_util.get(kind) else None)
            out[f"{scen}/{NAMES[kind]}"] = {
                "util_stat": cal.stationary_util,
                "sla_stat": cal.stationary_sla,
                "util_ret": cal.retuned.utilization,
                "sla_ret": cal.retuned.sla_fail,
                "theta_ret": cal.retuned.theta,
                "theta_stat": cal.stationary_theta,
                "dropped": dropped, "vs_baseline": rel,
                "n_sims": cal.retuned.n_sims + len(run_seeds),
                "seconds": time.perf_counter() - t0}

    # -- information-model replay: GLOBAL vs PSEUDO vs labeled ---------------
    # one baseline trace ensemble replayed under each information model
    # (arrivals identical, beliefs differ) through the trace-level plan
    n_ens = max(scale.n_runs, 4)
    traces = [synthesize_scenario(ts, "baseline", spec, device=device)
              for ts in split_seeds(_seed_word(seed, 900), n_ens)]
    pol2 = make_policy(SECOND, rho=tuned[SECOND], capacity=cfg.capacity)
    for mode, mname in ((GLOBAL, "global"), (PSEUDO, "pseudo"),
                        (MIX_LABELED, "labeled")):
        t0 = time.perf_counter()
        mcfg = replay_cfg._replace(prior_mode=mode, n_pseudo_obs=5)
        streams = [trace_to_stream(
            tr, mcfg, gen=torch.Generator(device=tr.c0.device).manual_seed(
                _seed_word(seed, 910 + ti)))[0]
            for ti, tr in enumerate(traces)]
        plan = make_trace_ensemble_plan(_seed_word(seed, 920), mcfg, grid,
                                        streams, quotas=(4, 2, 2),
                                        runs_per_trace=2)
        metrics = simulate_trace_plan(
            make_run(mcfg, grid, SECOND, device=device), plan, streams, pol2)
        est = estimate_from_plan(plan, metrics)
        out[f"info_model/{mname}"] = dict(
            est, ensemble=n_ens, p_bucket=plan.p_bucket.tolist(),
            seconds=time.perf_counter() - t0)

    # -- the seed-level importance plan, simulated in one batch --------------
    t0 = time.perf_counter()
    plan = make_importance_plan(_seed_word(seed, 17), cfg, grid,
                                quotas=(4, 4, 4), n_probe=128,
                                probe_batch=64, device=device)
    pol = make_policy(ZEROTH, threshold=tuned[ZEROTH], capacity=cfg.capacity)
    metrics = simulate_plan(make_run(cfg, grid, ZEROTH, device=device), plan,
                            pol)
    est = estimate_from_plan(plan, metrics)
    out["importance_routed"] = dict(
        est, p_bucket=plan.p_bucket.tolist(),
        seconds=time.perf_counter() - t0)
    return out


def rows(res: dict) -> list:
    """The JAX package's ``scenarios/*`` CSV rows from ``results``."""
    out = []
    for name, r in res.items():
        us = 1e6 * r["seconds"]
        if name.startswith("fit_roundtrip_"):
            derived = (f"max_relerr={r['max_relerr']:.3f}({r['worst']})"
                       f" nu={r['nu']:.3f} delta={r['delta']:.4f}")
        elif name.startswith("info_model/"):
            derived = (f"util={r['utilization']:.4f} sla={r['sla_fail']:.2e}"
                       f" n_runs={r['n_runs']} ensemble={r['ensemble']}")
        elif name == "importance_routed":
            derived = (f"sla={r['sla_fail']:.2e} util={r['utilization']:.4f}"
                       f" n_runs={r['n_runs']} batched=run_keyed_batch")
        else:
            rel = ("" if r["vs_baseline"] is None
                   else f" vs_baseline={r['vs_baseline']:+.1%}")
            derived = (f"util_stat={r['util_stat']:.4f}"
                       f" sla_stat={r['sla_stat']:.2e}"
                       f" util_ret={r['util_ret']:.4f}"
                       f" sla_ret={r['sla_ret']:.2e}"
                       f" theta_ret={r['theta_ret']:.4g}"
                       f" dropped={r['dropped']}{rel}")
        out.append(csv_row(f"scenarios/{name}", us, derived))
    return out


def run(scale_name: str = "tiny", seed: int = 0,
        device="cuda") -> list:
    """The sweep's CSV rows, as the JAX package's ``run`` returns them."""
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
                       "rows": res}, f, indent=1, default=float)


if __name__ == "__main__":
    main()
