"""The ``agg_refresh_steps`` K-curve: measure it, record it, select from it.

The simulator's scan is blocked by ``agg_refresh_steps`` (= K): the
cluster-wide aggregate moment curves are fully recomputed once per block and
maintained incrementally in between. Staleness cuts both ways — missed
deaths are conservative, missed scale-out growth is optimistic — and the
residual bias is absorbed by threshold tuning *at the same K*. So the honest
way to pick K is a measured curve: sweep K at the fixed stationary-tuned
theta **and** with the theta re-tuned per K, record utilization and
SLA-slack (tau minus the measured failure rate) against K, and pick the
largest K that keeps the re-tuned operating point SLA-feasible without
giving up utilization.

``benchmarks/tuning_bench.py`` runs the sweep and records one row per K into
``BENCH_<scale>.json``; ``pick_agg_refresh`` reads the recorded curve back
(committed artifact — no simulation at import time) and is what
``repro_torch.benchmarks.common.sim_config`` consumes instead of the
hand-picked 4/8/12 per preset.

PyTorch counterpart of ``repro.tuning.kcurve``: the same row format, so both
packages read the same committed ``BENCH_<scale>.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Sequence

import numpy as np

from ..sim.core import SimConfig
from ..sim.simulator import make_run
from .calibrate import calibrate, eval_theta_grid, sla_ci

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

#: a K-point this close to the best re-tuned utilization counts as "free"
DEFAULT_UTIL_TOL = 0.01


def kcurve_divisors(n_steps: int, k_max: int = 16) -> list[int]:
    """Candidate refresh intervals: divisors of ``n_steps`` up to ``k_max``
    (the scan requires K | n_steps; see ``SimConfig`` validation)."""
    return [k for k in range(1, k_max + 1) if n_steps % k == 0]


@dataclasses.dataclass(frozen=True)
class KPoint:
    """One measured K: operating points at fixed and re-tuned thetas."""

    k: int
    theta_fixed: float
    util_fixed: float
    slack_fixed: float        # tau - sla_fail at the fixed theta
    theta_retuned: float
    util_retuned: float
    slack_retuned: float
    retuned_feasible: bool


def sweep_kcurve(
    cfg: SimConfig,
    grid,
    kind: int,
    keys,
    *,
    tau: float,
    ks: Optional[Sequence[int]] = None,
    theta_fixed: Optional[float] = None,
    n_grid: int = 6,
    max_stages: int = 2,
    devices=None,
    device="cuda",
) -> list[KPoint]:
    """Measure the K-curve for one policy kind.

    ``theta_fixed`` defaults to a calibration at the smallest K in ``ks``
    (the least-stale reference); each K then gets (a) that fixed theta
    evaluated as-is — the bias you eat by *not* re-tuning after changing K —
    and (b) a full re-calibration at that K, which is the operating point a
    deployment would actually run. All evaluations share ``keys`` (common
    random numbers), so the curve is smooth in K up to trajectory divergence.
    ``keys`` are run seeds; the runs go on ``device`` (the card unless the
    caller passes ``"cpu"``).
    """
    ks = kcurve_divisors(cfg.n_steps) if ks is None else sorted(ks)
    if not ks:
        raise ValueError(f"no candidate K divides n_steps={cfg.n_steps}")
    ref_cfg = cfg._replace(agg_refresh_steps=ks[0])
    ref_run = make_run(ref_cfg, grid, kind, device=device)
    ref = None
    if theta_fixed is None:
        ref = calibrate(ref_run, kind, keys, capacity=cfg.capacity, tau=tau,
                        n_grid=n_grid, max_stages=max_stages, devices=devices)
        theta_fixed = ref.theta

    points = []
    for k in ks:
        run_fn = (ref_run if k == ks[0]
                  else make_run(cfg._replace(agg_refresh_steps=k), grid, kind,
                                device=device))
        m = eval_theta_grid(run_fn, kind, [theta_fixed], keys,
                            capacity=cfg.capacity, devices=devices)
        sla_f, _, _ = sla_ci(m.failed_requests[0].cpu().numpy(),
                             m.total_requests[0].cpu().numpy())
        util_f = float(np.mean(m.utilization[0].cpu().numpy()))
        if k == ks[0] and ref is not None:
            res = ref  # the reference calibration IS this K's re-tune
        else:
            res = calibrate(run_fn, kind, keys, capacity=cfg.capacity,
                            tau=tau, n_grid=n_grid, max_stages=max_stages,
                            devices=devices)
        points.append(KPoint(
            k=int(k), theta_fixed=float(theta_fixed), util_fixed=util_f,
            slack_fixed=float(tau - sla_f), theta_retuned=res.theta,
            util_retuned=res.utilization,
            slack_retuned=float(tau - res.sla_fail),
            retuned_feasible=res.feasible,
        ))
    return points


def pick_from_curve(points: Sequence[KPoint],
                    util_tol: float = DEFAULT_UTIL_TOL) -> int:
    """Select K from a measured curve: among K whose *re-tuned* operating
    point is SLA-feasible (slack >= 0) and within ``util_tol`` of the best
    re-tuned utilization, take the largest (refresh cost falls ~linearly in
    K). Falls back to the smallest measured K when nothing is feasible."""
    if not points:
        raise ValueError("empty K-curve")
    ok = [p for p in points if p.retuned_feasible and p.slack_retuned >= 0.0]
    if not ok:
        return min(points, key=lambda p: p.k).k
    best_util = max(p.util_retuned for p in ok)
    free = [p for p in ok if p.util_retuned >= best_util - util_tol]
    return max(free, key=lambda p: p.k).k


# ---------------------------------------------------------------------------
# BENCH_<scale>.json (de)serialization — the bench rows are the persistence
# format, so the writer (benchmarks/tuning_bench.py) and the reader
# (pick_agg_refresh via load_kcurve) share these two functions.
# ---------------------------------------------------------------------------

KCURVE_ROW_PREFIX = "tuning/kcurve"

_DERIVED_RE = re.compile(
    r"util_fixed=(?P<uf>[-\d.e+]+) slack_fixed=(?P<sf>[-\d.e+]+)"
    r" util_retuned=(?P<ur>[-\d.e+]+) slack_retuned=(?P<sr>[-\d.e+]+)"
    r" theta_fixed=(?P<tf>[-\d.e+]+) theta_retuned=(?P<tr>[-\d.e+]+)"
    r" feasible=(?P<fe>[01])")


def kcurve_row_name(scale_name: str, k: int) -> str:
    return f"{KCURVE_ROW_PREFIX}/{scale_name}/K={k}"


def format_kcurve_derived(p: KPoint) -> str:
    return (f"util_fixed={p.util_fixed:.4f} slack_fixed={p.slack_fixed:.3e}"
            f" util_retuned={p.util_retuned:.4f}"
            f" slack_retuned={p.slack_retuned:.3e}"
            f" theta_fixed={p.theta_fixed:.6g}"
            f" theta_retuned={p.theta_retuned:.6g}"
            f" feasible={int(p.retuned_feasible)}")


def parse_kcurve_rows(rows, scale_name: str) -> list[KPoint]:
    """Recover KPoints from BENCH rows (``{"name": ..., "derived": ...}``)."""
    prefix = f"{KCURVE_ROW_PREFIX}/{scale_name}/K="
    points = []
    for row in rows:
        name = row.get("name", "")
        if not name.startswith(prefix):
            continue
        m = _DERIVED_RE.match(row.get("derived", ""))
        if not m:
            continue
        points.append(KPoint(
            k=int(name[len(prefix):]),
            theta_fixed=float(m["tf"]), util_fixed=float(m["uf"]),
            slack_fixed=float(m["sf"]), theta_retuned=float(m["tr"]),
            util_retuned=float(m["ur"]), slack_retuned=float(m["sr"]),
            retuned_feasible=m["fe"] == "1",
        ))
    return sorted(points, key=lambda p: p.k)


_BENCH_CACHE: dict = {}


def _read_bench_rows(path: str):
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return None
    cached = _BENCH_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    try:
        with open(path, encoding="utf-8") as f:
            rows = json.load(f).get("rows", [])
    except (OSError, ValueError):
        return None
    _BENCH_CACHE[path] = (mtime, rows)
    return rows


def load_kcurve(scale_name: str,
                bench_path: Optional[str] = None) -> list[KPoint]:
    """The recorded K-curve for a scale, from committed BENCH artifacts.

    Looks in ``bench_path`` when given (or ``$REPRO_BENCH_JSON``), otherwise
    ``BENCH_<scale>.json`` at the repo root — row names carry the scale
    (``tuning/kcurve/<scale>/K=...``), so only rows measured at this scale
    ever parse. Returns ``[]`` when no curve has been recorded yet."""
    candidates = ([bench_path] if bench_path else
                  ([os.environ["REPRO_BENCH_JSON"]]
                   if os.environ.get("REPRO_BENCH_JSON") else
                   [os.path.join(_REPO_ROOT, f"BENCH_{scale_name}.json")]))
    for path in candidates:
        rows = _read_bench_rows(path)
        if rows is None:
            continue
        points = parse_kcurve_rows(rows, scale_name)
        if points:
            return points
    return []


def pick_agg_refresh(scale_name: str, *, fallback: int = 1,
                     n_steps: Optional[int] = None,
                     bench_path: Optional[str] = None,
                     util_tol: float = DEFAULT_UTIL_TOL) -> int:
    """Per-scale refresh interval from the measured K-curve.

    Returns ``pick_from_curve`` over the recorded curve for ``scale_name``;
    ``fallback`` (the preset's hand-picked value) when none is recorded. When
    ``n_steps`` is given the choice must divide it (config overrides can
    change the horizon after the curve was measured) — infeasible choices
    fall back likewise."""
    points = load_kcurve(scale_name, bench_path)
    if n_steps is not None:
        points = [p for p in points if n_steps % p.k == 0]
    if not points:
        return fallback
    k = pick_from_curve(points, util_tol)
    if n_steps is not None and n_steps % k != 0:
        return fallback
    return k
