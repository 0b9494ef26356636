"""Shared benchmark machinery: scale presets, policy tuning, CSV rows.

The paper's experiments (c=20,000, 3 years, 500 runs, SLA 1e-4) are the
``full`` preset's scale; ``tiny`` and ``quick`` scale the system down while
keeping its phenomena (a heavy-tailed deployment mix, tail-risk
admissions). Utilizations are comparable across policies within a preset.

Tuning (paper §5.2: search subject to the SLA) lives in
``repro_torch.tuning``: ``tune_and_eval`` is a preset-aware wrapper around
``tuning.calibrate`` (one batched run a stage, CI-aware stopping) that adds
the BCa utilization interval the benchmarks report.

Each preset's ``agg_refresh`` is only the hand-picked fallback for the
aggregate-refresh interval: ``sim_config`` asks ``tuning.pick_agg_refresh``
first, which selects K from the K-curve recorded in ``BENCH_<scale>.json``.

PyTorch counterpart of the JAX package's ``benchmarks/common.py``, with the
same presets. Run seeds come from ``sim.split_seeds`` (the JAX package
splits a PRNG key), so the two packages draw different runs.
"""
from __future__ import annotations

import dataclasses
import time

from ..core import AZURE_PRIORS, SECOND, geometric_grid
from ..sim import SimConfig, bca_ci, make_run, split_seeds
from ..tuning import calibrate, pick_agg_refresh


@dataclasses.dataclass(frozen=True)
class Scale:
    name: str
    capacity: float
    arrival_rate: float
    horizon_hours: float
    dt: float
    max_slots: int
    n_runs: int
    n_thresholds: int
    grid_points: int
    tau: float            # scale-adjusted SLA
    agg_refresh: int = 1  # hand-picked refresh-interval fallback; the
                          # recorded K-curve wins when there is one


SCALES = {
    # the regime of the paper (cluster >> single deployment, tail risk from
    # early heavy arrivals) at smaller cost; horizons are chosen so that
    # agg_refresh divides the step count (456 d / 548 d / 3 y)
    "tiny": Scale("tiny", 2_500.0, 0.125, 456 * 24.0, 12.0, 768, 4, 4,
                  24, 1e-3, agg_refresh=4),
    "quick": Scale("quick", 5_000.0, 0.25, 548 * 24.0, 12.0, 1536, 8, 6,
                   32, 5e-4, agg_refresh=8),
    "full": Scale("full", 20_000.0, 1.0, 3.0 * 365 * 24, 6.0, 8192, 24, 8,
                  48, 1e-4, agg_refresh=12),
}


#: the seconds-scale preset of ``tuning_bench`` and ``serve_bench`` (the
#: JAX package's ``REPRO_SMOKE=1`` preset): it exercises their row machinery
SMOKE_SCALE = Scale("smoke", 800.0, 0.05, 60 * 24.0, 24.0, 128, 2, 3,
                    16, 5e-3, agg_refresh=1)


def scale_for(scale_name: str) -> Scale:
    """The preset ``scale_name``: one of ``SCALES``, or ``"smoke"``."""
    return SMOKE_SCALE if scale_name == "smoke" else SCALES[scale_name]


def sim_config(scale: Scale, **over) -> SimConfig:
    """Preset -> SimConfig. ``agg_refresh_steps`` comes from the K-curve
    recorded for this scale (``tuning.pick_agg_refresh`` over the committed
    BENCH file) when there is one that divides the step count, else from
    the preset."""
    base = dict(capacity=scale.capacity, arrival_rate=scale.arrival_rate,
                horizon_hours=scale.horizon_hours, dt=scale.dt,
                max_slots=scale.max_slots, max_arrivals=5,
                priors=AZURE_PRIORS)
    base.update(over)
    if "agg_refresh_steps" not in over:
        probe = SimConfig(**base)
        base["agg_refresh_steps"] = pick_agg_refresh(
            scale.name, fallback=scale.agg_refresh, n_steps=probe.n_steps)
    return SimConfig(**base)


def grid_for(scale: Scale, cfg: SimConfig, device=None):
    return geometric_grid(cfg.dt, cfg.horizon_hours * 3.0, scale.grid_points,
                          device=device)


def tune_and_eval(scale: Scale, kind: int, cfg: SimConfig, *,
                  marginal: bool = False, seed: int = 0,
                  lo: float = None, hi: float = None,
                  device="cuda") -> dict:
    """Preset-aware ``tuning.calibrate`` + the BCa utilization interval, on
    ``device`` (the card unless the caller passes ``"cpu"``).

    Each stage's whole theta grid runs as one batch of T x ``n_runs`` runs,
    and refinement stops once the SLA estimate's CI separates from the
    scale's tau. Max-feasible selection, as the JAX package's.
    """
    grid = grid_for(scale, cfg)
    run_fn = make_run(cfg, grid, kind, device=device)
    seeds = split_seeds(seed, scale.n_runs)
    t0 = time.perf_counter()
    res = calibrate(
        run_fn, kind, seeds, capacity=cfg.capacity, tau=scale.tau,
        lo=lo, hi=hi,
        n_grid=scale.n_thresholds + (2 if kind == SECOND else 0),
        max_stages=2, marginal=marginal)
    seconds = time.perf_counter() - t0
    ci = bca_ci(res.util_runs, n_resamples=2_000)
    return {
        "kind": kind, "param": res.theta, "feasible": res.feasible,
        "utilization": ci.estimate, "ci_lo": ci.lo, "ci_hi": ci.hi,
        "sla_fail": res.sla_fail, "sla_lo": res.sla_lo,
        "sla_hi": res.sla_hi, "tau": scale.tau,
        "stages": [[float(x) for x in st.thetas] for st in res.stages],
        "n_sims": res.n_sims, "seconds": seconds,
        "run_steps": res.n_sims * cfg.n_steps,
    }


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
