"""Calibration subsystem (paper §5.2): batched SLA tuning, per-scenario
re-tuning, the ``agg_refresh`` K-curve and drift-aware recalibration, in
PyTorch.

  * ``calibrate`` — whole-theta-grid SLA-constrained search in one batched
    run, CI-aware stage stopping, every policy kind in ``core.policies``;
    the serial ``core.policies.tune_threshold`` bisection is the oracle the
    tests compare it against.
  * ``kcurve`` — utilization and SLA slack against ``agg_refresh_steps``;
    ``pick_agg_refresh`` selects the per-scale refresh interval from the
    curve recorded in ``BENCH_<scale>.json``.
  * ``scenarios`` — re-tune a policy against a trace scenario's own replay
    streams and report stationary-tuned vs re-tuned operating points at
    matched SLA (the robustness gap, measured).
  * ``drift`` — drift-aware streaming recalibration: censoring-robust drift
    channels over the windowed sufficient statistics, a Monte-Carlo-
    calibrated two-sided CUSUM detector (offline over replay windows and
    live via the engine's telemetry), warm-started re-tuning around the
    incumbent, and the never/triggered/oracle regret protocol.
"""
from .calibrate import (SPACE_LINEAR, SPACE_LOG10, CalibrationResult,
                        ProbeStage, calibrate, eval_theta_grid, from_param,
                        sla_ci, theta_space, to_param)
from .kcurve import (DEFAULT_UTIL_TOL, KPoint, format_kcurve_derived,
                     kcurve_divisors, kcurve_row_name, load_kcurve,
                     parse_kcurve_rows, pick_agg_refresh, pick_from_curve,
                     sweep_kcurve)
from .scenarios import (ScenarioCalibration, calibrate_scenario,
                        replay_stream_batch)
from .drift import (DRIFT_CHANNELS, DriftArm, DriftDetector, DriftNull,
                    DriftProtocolResult, DriftReport, DriftUpdate,
                    calibrate_drift_detector, channels_from_obs,
                    channels_from_stats, detect_drift, null_from_replays,
                    retune_warm, run_drift_protocol, warm_theta_bounds,
                    window_channel_values)

__all__ = [
    "SPACE_LINEAR", "SPACE_LOG10", "CalibrationResult", "ProbeStage",
    "calibrate", "eval_theta_grid", "from_param", "sla_ci", "theta_space",
    "to_param",
    "DEFAULT_UTIL_TOL", "KPoint", "format_kcurve_derived", "kcurve_divisors",
    "kcurve_row_name", "load_kcurve", "parse_kcurve_rows", "pick_agg_refresh",
    "pick_from_curve", "sweep_kcurve",
    "ScenarioCalibration", "calibrate_scenario", "replay_stream_batch",
    "DRIFT_CHANNELS", "DriftArm", "DriftDetector", "DriftNull",
    "DriftProtocolResult", "DriftReport", "DriftUpdate",
    "calibrate_drift_detector", "channels_from_obs", "channels_from_stats",
    "detect_drift", "null_from_replays", "retune_warm", "run_drift_protocol",
    "warm_theta_bounds", "window_channel_values",
]
