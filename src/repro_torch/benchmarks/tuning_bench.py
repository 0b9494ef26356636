"""Calibration rows: batched SLA tuning and the aggregate-refresh K-curve.

Two row families, both read back by programs, not only by people:

  * ``tuning/calibrate/<kind>`` — ``repro_torch.tuning.calibrate`` on the
    preset's prior-drawn arrivals for every policy kind: the tuned theta,
    its utilization, the measured SLA rate with its cluster-robust CI, and
    the stages and simulations the CI-aware stopping spent.
    ``serve_bench`` republishes these thetas as the daemon's operating
    points.
  * ``tuning/kcurve/<scale>/K=<k>`` — utilization and SLA slack against the
    aggregate-refresh interval K, at the smallest K's theta (fixed) and
    re-tuned at each K. These rows are what ``tuning.pick_agg_refresh``
    reads back from a BENCH file; ``tuning/pick_agg_refresh/<scale>`` is
    the selection made from the freshly measured curve, through the same
    serialisation.

``scale_name="smoke"`` selects a seconds-scale preset (the JAX package's
``REPRO_SMOKE=1`` preset) that exercises the row machinery: the sweep, the
serialisation and the selection round trip.

PyTorch counterpart of the JAX package's ``benchmarks/tuning_bench.py``,
on ``device`` (the card unless the caller passes ``"cpu"``):

    python -m repro_torch.benchmarks.run --scale quick --only tuning
"""
from __future__ import annotations

import time

from ..core import FIRST, SECOND, ZEROTH
from ..sim import make_run, split_seeds
from ..tuning import (calibrate, format_kcurve_derived, kcurve_divisors,
                      kcurve_row_name, parse_kcurve_rows, pick_from_curve,
                      sweep_kcurve)
from .common import csv_row, grid_for, scale_for, sim_config

NAMES = {ZEROTH: "zeroth", FIRST: "first", SECOND: "second"}

#: the K-curve is measured on the paper's headline policy (the threshold
#: policies' curves respond to K the same way through tuning)
KCURVE_KIND = SECOND


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    scale = scale_for(scale_name)
    smoke = scale.name == "smoke"
    cfg = sim_config(scale)
    grid = grid_for(scale, cfg)
    seeds = split_seeds(seed, scale.n_runs)
    rows = []

    # -- calibrate every policy kind on the preset ---------------------------
    for kind in (ZEROTH, FIRST, SECOND):
        t0 = time.perf_counter()
        res = calibrate(make_run(cfg, grid, kind, device=device), kind,
                        seeds, capacity=cfg.capacity, tau=scale.tau,
                        n_grid=scale.n_thresholds + (2 if kind == SECOND
                                                     else 0),
                        max_stages=2)
        rows.append(csv_row(
            f"tuning/calibrate/{NAMES[kind]}",
            (time.perf_counter() - t0) * 1e6,
            f"theta={res.theta:.6g} util={res.utilization:.4f}"
            f" sla={res.sla_fail:.2e}(ci {res.sla_lo:.1e}:{res.sla_hi:.1e})"
            f"<=tau={res.tau:.0e} stages={len(res.stages)}"
            f" sims={res.n_sims} separated={int(res.separated)}"))

    # -- the agg_refresh K-curve --------------------------------------------
    ks = kcurve_divisors(cfg.n_steps, k_max=4 if smoke else 16)
    t0 = time.perf_counter()
    points = sweep_kcurve(cfg, grid, KCURVE_KIND, seeds, tau=scale.tau,
                          ks=ks, n_grid=scale.n_thresholds, max_stages=1,
                          device=device)
    us_total = (time.perf_counter() - t0) * 1e6
    for p in points:
        rows.append(csv_row(kcurve_row_name(scale.name, p.k),
                            us_total / max(len(points), 1),
                            format_kcurve_derived(p)))
    # the selection through the rows' serialisation: what pick_agg_refresh
    # reads back from a BENCH file
    parsed = parse_kcurve_rows(
        [{"name": r.split(",", 2)[0], "derived": r.split(",", 2)[2]}
         for r in rows], scale.name)
    chosen = pick_from_curve(parsed)
    rows.append(csv_row(
        f"tuning/pick_agg_refresh/{scale.name}", 0.0,
        f"K={chosen} candidates={ks} hand_picked={scale.agg_refresh}"))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
