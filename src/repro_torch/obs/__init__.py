"""Observability: device-side telemetry, decision tracing, live export.

The port's counterpart of the JAX package's ``obs``
(``docs/observability.md``):

  counters — the ``TelemetryState`` rider carried in ``CoreState`` through
             ``make_run`` and the online engine (``SimConfig(telemetry=True)``;
             off by default, decisions/metrics bit-identical either way)
  tracing  — buffered per-decision JSONL records + ``torch.profiler`` ranges
  export   — host histograms, Prometheus text rendering, and the
             ``/metrics`` HTTP server the admission daemon mounts
  log      — the shared ``repro_torch``-rooted stdlib logger
             (``REPRO_LOG_LEVEL`` env var; silent by default)
"""
from .counters import (N_OCC_BINS, N_STALENESS_BINS, TelemetryState,
                       WindowStats, fold_decisions, fold_window,
                       init_telemetry, mark_refresh, telemetry_summary)
from .export import (LATENCY_BUCKETS_S, HostHistogram, Metric, MetricsServer,
                     log_buckets, render_prometheus, snapshot_to_prometheus)
from .log import get_logger, set_level
from .tracing import DecisionTracer, annotate

__all__ = [
    "N_OCC_BINS", "N_STALENESS_BINS", "TelemetryState", "WindowStats",
    "fold_decisions", "fold_window", "init_telemetry", "mark_refresh",
    "telemetry_summary",
    "LATENCY_BUCKETS_S", "HostHistogram", "Metric", "MetricsServer",
    "log_buckets", "render_prometheus", "snapshot_to_prometheus",
    "get_logger", "set_level",
    "DecisionTracer", "annotate",
]
