"""Trace-driven workload subsystem: schema, generators, fitting, replay.

The paper's evaluation is grounded in a Microsoft Azure trace; this package
makes the port trace-driven end to end:

  * ``schema``  — ``WorkloadTrace``: a columnar, fixed-capacity record of
    one workload (arrivals, latents, observables, scale-out event streams)
    as tensors on one device, with lossless NPZ and human-readable CSV
    persistence in the JAX package's formats.
  * ``synth``   — vectorized generators that synthesize Azure-like traces
    from ``PopulationPriors`` with a ``torch.Generator``, plus composable
    scenario modifiers (diurnal rate modulation, flash-crowd bursts,
    heavy-tail lifetime inflation, correlated batch arrivals, prior drift)
    behind a scenario registry.
  * ``fit``     — moment-matching + Gamma-MLE recovery of
    ``PopulationPriors`` from any trace (latent or observables-only), on
    the host in float64.
  * ``replay``  — ``TraceArrivalSource``: any trace as a simulator arrival
    backend, under every information model.
  * ``ingest``  — Cortez/Azure-format VM-table CSV → ``WorkloadTrace``.

ArrivalSource contract (``sim.core.ArrivalSource``): a source's
``stream(gen, cfg)`` returns the same pre-drawn ``[n_steps, max_arrivals]``
``ArrivalStream`` that ``draw_arrival_stream`` produces, so
``make_run(cfg, grid, kind, arrival_source=...)`` is the single switch, and
an explicit ``stream=`` argument to the built run still overrides it.

PyTorch counterpart of ``repro.traces``, with the same scenarios.
"""
from .schema import (ScaleoutEvents, WorkloadTrace, events_csv_path,
                     has_latents, host_trace, load_csv, load_npz,
                     n_deployments, save_csv, save_npz, trace_to,
                     validate_trace)
from .synth import (DRIFT_MU_SCALE, DRIFT_RAMP_FRACS, DRIFT_STEP_FRAC,
                    Scenario, TraceSpec, drift_mu_ramp, drift_mu_step,
                    drifted_priors, get_scenario, register_scenario,
                    scenario_names, synthesize_scenario, synthesize_trace)
from .fit import (NU_GRID, FitStats, fit_gamma_mle, fit_gamma_moments,
                  fit_priors, merge_stats, prior_relative_errors,
                  stats_to_priors, window_stats)
from .replay import (PSEUDO_AUTO, PSEUDO_LATENT, PSEUDO_OBSERVED,
                     ReplayDraws, TraceArrivalSource, params_from_trace,
                     trace_to_stream)
from .ingest import (AZURE_2017_POSITIONAL, CortezSchema, ingest_cortez_csv,
                     parse_core_bucket)

__all__ = [
    "ScaleoutEvents", "WorkloadTrace", "events_csv_path", "has_latents",
    "host_trace", "load_csv", "load_npz", "n_deployments", "save_csv",
    "save_npz", "trace_to", "validate_trace",
    "DRIFT_MU_SCALE", "DRIFT_RAMP_FRACS", "DRIFT_STEP_FRAC",
    "Scenario", "TraceSpec", "drift_mu_ramp", "drift_mu_step",
    "drifted_priors", "get_scenario", "register_scenario",
    "scenario_names", "synthesize_scenario", "synthesize_trace",
    "NU_GRID", "FitStats", "fit_gamma_mle", "fit_gamma_moments", "fit_priors",
    "merge_stats", "prior_relative_errors", "stats_to_priors", "window_stats",
    "PSEUDO_AUTO", "PSEUDO_LATENT", "PSEUDO_OBSERVED", "ReplayDraws",
    "TraceArrivalSource", "params_from_trace", "trace_to_stream",
    "AZURE_2017_POSITIONAL", "CortezSchema", "ingest_cortez_csv",
    "parse_core_bucket",
]
