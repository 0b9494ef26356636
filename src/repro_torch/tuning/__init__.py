"""Calibration subsystem (paper §5.2): batched SLA tuning and the
``agg_refresh`` K-curve, in PyTorch.

  * ``calibrate`` — whole-theta-grid SLA-constrained search in one batched
    run, CI-aware stage stopping, every policy kind in ``core.policies``;
    the serial ``core.policies.tune_threshold`` bisection is the oracle the
    tests compare it against.
  * ``kcurve`` — utilization and SLA slack against ``agg_refresh_steps``;
    ``pick_agg_refresh`` selects the per-scale refresh interval from the
    curve recorded in ``BENCH_<scale>.json``.

The JAX package's ``scenarios`` and ``drift`` modules are not ported yet
(ROADMAP.md, Queue A, item 8).
"""
from .calibrate import (SPACE_LINEAR, SPACE_LOG10, CalibrationResult,
                        ProbeStage, calibrate, eval_theta_grid, from_param,
                        sla_ci, theta_space, to_param)
from .kcurve import (DEFAULT_UTIL_TOL, KPoint, format_kcurve_derived,
                     kcurve_divisors, kcurve_row_name, load_kcurve,
                     parse_kcurve_rows, pick_agg_refresh, pick_from_curve,
                     sweep_kcurve)

__all__ = [
    "SPACE_LINEAR", "SPACE_LOG10", "CalibrationResult", "ProbeStage",
    "calibrate", "eval_theta_grid", "from_param", "sla_ci", "theta_space",
    "to_param",
    "DEFAULT_UTIL_TOL", "KPoint", "format_kcurve_derived", "kcurve_divisors",
    "kcurve_row_name", "load_kcurve", "parse_kcurve_rows", "pick_agg_refresh",
    "pick_from_curve", "sweep_kcurve",
]
