"""Fleet router comparison at a matched fleet SLA (paper §2's provider view:
dispatch, then admit).

The preset's capacity is split into a heterogeneous fleet (``FLEET_FRACS``:
a big, two mid and a small cluster, each with half the preset's slots);
for every router the shared second-moment policy is calibrated against the
*fleet* SLA target in one batched run a stage (``tuning.calibrate`` with a
``fleet_policy`` closure, so per-cluster thresholds stay in proportion to
capacity), and the reported utilizations compare routers at the same risk
budget. One more batch at the tuned rho gives the routing diagnostics the
calibration does not carry: the arrivals rejected by all clusters and the
spread of the clusters' utilizations.

    python -m repro_torch.benchmarks.fleet_bench --scale quick
    python -m repro_torch.benchmarks.fleet_bench --scale tiny --device cpu

prints one CSV row a router and the trace-replay row (the JAX package's
``scenarios/fleet/*`` rows) and, with ``--json PATH``, writes every number
of the rows to PATH. The replay row replays a synthesized baseline trace
into the fleet at the least-utilized router's tuned rho: arrivals come
from the trace (at most ``REPLAY_MAX_ARRIVALS`` a step), the router still
decides the cluster.
"""
from __future__ import annotations

import argparse
import json
import time

from ..core import SECOND, fleet_policy
from ..sim import (ROUTERS, FleetConfig, make_fleet_run, sla_failure_rate,
                   split_seeds)
from ..sim.simulator import _seed_word
from ..traces import TraceArrivalSource, synthesize_scenario
from ..tuning import calibrate
from .common import SCALES, csv_row, grid_for, sim_config
from .scenarios import REPLAY_MAX_ARRIVALS, trace_spec_for

#: heterogeneous fleet split of the preset capacity (a big, two mid, a small
#: cluster) — heterogeneity is what separates capacity-aware routers from
#: the random baseline
FLEET_FRACS = (0.4, 0.3, 0.2, 0.1)
FLEET_ROUTERS = ("least_utilized", "power_of_two", "random", "cascade")


def fleet_config(scale_name: str) -> FleetConfig:
    """The preset's fleet: ``FLEET_FRACS`` of its capacity, each cluster
    with half its slots (at least 64), its arrivals fleet-wide."""
    scale = SCALES[scale_name]
    cfg = sim_config(scale)
    caps = tuple(round(f * scale.capacity, 1) for f in FLEET_FRACS)
    base = cfg._replace(max_slots=max(cfg.max_slots // 2, 64))
    return FleetConfig(base=base, capacities=caps)


def results(scale_name: str = "tiny", seed: int = 0,
            device="cuda") -> dict:
    """{router name: its numbers} at the preset ``scale_name``."""
    scale = SCALES[scale_name]
    fcfg = fleet_config(scale_name)
    caps = fcfg.capacities
    grid = grid_for(scale, fcfg.base)
    seeds = split_seeds(seed, scale.n_runs)
    policy_fn = lambda th: fleet_policy(SECOND, capacities=caps, rho=th)
    out = {}
    for name in FLEET_ROUTERS:
        t0 = time.perf_counter()
        run_fn = make_fleet_run(fcfg, grid, SECOND, router=ROUTERS[name](),
                                device=device)
        cal = calibrate(run_fn, SECOND, seeds,
                        capacity=fcfg.total_capacity, tau=scale.tau,
                        n_grid=scale.n_thresholds, max_stages=1,
                        policy_fn=policy_fn)
        m = run_fn(seeds, policy_fn(cal.theta))
        per_cluster = m.per_cluster.utilization.cpu().numpy().mean(axis=0)
        out[name] = {
            "utilization": cal.utilization, "sla_fail": cal.sla_fail,
            "rho": cal.theta, "feasible": cal.feasible, "tau": scale.tau,
            "rej_all": float(m.rejected_by_all.cpu().numpy().mean()),
            "util_spread": float(per_cluster.max() - per_cluster.min()),
            "cluster_utilization": per_cluster.tolist(),
            "n_clusters": len(caps), "capacities": list(caps),
            "n_sims": cal.n_sims + len(seeds),
            "seconds": time.perf_counter() - t0,
        }
    return out


def replay(scale_name: str, rho: float, seed: int = 0,
           device="cuda") -> dict:
    """A synthesized baseline trace replayed INTO the preset's fleet
    (arrivals routed live by the least-utilized router) at ``rho``, over
    ``results``' runs."""
    scale = SCALES[scale_name]
    fcfg = fleet_config(scale_name)
    grid = grid_for(scale, fcfg.base)
    seeds = split_seeds(seed, scale.n_runs)
    policy_fn = lambda th: fleet_policy(SECOND, capacities=fcfg.capacities,
                                        rho=th)
    t0 = time.perf_counter()
    trace = synthesize_scenario(_seed_word(seed, 7), "baseline",
                                trace_spec_for(fcfg.base), device=device)
    source = TraceArrivalSource(trace)
    rcfg = FleetConfig(base=fcfg.base._replace(
        max_arrivals=REPLAY_MAX_ARRIVALS), capacities=fcfg.capacities)
    run_fn = make_fleet_run(rcfg, grid, SECOND,
                            router=ROUTERS["least_utilized"](),
                            arrival_source=source, device=device)
    m = run_fn(seeds, policy_fn(rho))
    return {"utilization": float(m.utilization.mean()),
            "sla_fail": sla_failure_rate(m.failed_requests.cpu().numpy(),
                                         m.total_requests.cpu().numpy()),
            "rho": rho, "dropped": source.n_dropped(rcfg),
            "n_sims": len(seeds), "seconds": time.perf_counter() - t0}


def rows(res: dict, rep: dict) -> list:
    """One CSV row a router (``results``) and the replay row (``replay``),
    as the JAX package's ``scenarios/fleet/*``."""
    return [csv_row(
        f"scenarios/fleet/{name}", 1e6 * r["seconds"],
        f"util={r['utilization']:.4f} sla={r['sla_fail']:.2e}"
        f" rho={r['rho']:.4g} feasible={r['feasible']}"
        f" rej_all={r['rej_all']:.1f}"
        f" util_spread={r['util_spread']:.3f}"
        f" n_clusters={r['n_clusters']} tau={r['tau']:g}")
        for name, r in res.items()] + [csv_row(
            "scenarios/fleet/replay_least_utilized", 1e6 * rep["seconds"],
            f"util={rep['utilization']:.4f} sla={rep['sla_fail']:.2e}"
            f" rho={rep['rho']:.4g} dropped={rep['dropped']}")]


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    """The routers' rows and the replay row, as the JAX package's ``run``
    returns them."""
    res = results(scale_name, seed, device)
    return rows(res, replay(scale_name, res["least_utilized"]["rho"], seed,
                            device))


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
    rep = replay(args.scale, res["least_utilized"]["rho"], args.seed,
                 args.device)
    wall = time.perf_counter() - t0
    for row in rows(res, rep):
        print(row, flush=True)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"scale": args.scale, "seed": args.seed,
                       "device": args.device, "wall_s": wall,
                       "routers": res, "replay": rep}, f, indent=1)


if __name__ == "__main__":
    main()
