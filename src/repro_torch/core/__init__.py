"""Moment-based cluster admission control (paper §2–§4), in PyTorch.

Public API (the ported part of ``repro.core``):
  processes  — deployment stochastic processes + fitted Azure priors
  belief     — conjugate Gamma belief state over scaling parameters
  moments    — closed-form E[L_t]/V[L_t] curves (continuous) and aggregates
  policies   — zeroth/first/second moment policies, marginal heuristic
"""
from .processes import (AZURE_PRIORS, DeploymentParams, PopulationPriors,
                        StepEvents, sample_params, sample_step_events,
                        scaleout_rate)
from .belief import (GammaBelief, belief_from_prior, observe_initial_size,
                     update_on_events)
from .moments import (MomentCurves, aggregate_moment_curves,
                      masked_curve_reduction, moment_curves,
                      moment_curves_fused)
from .policies import (FIRST, SECOND, ZEROTH, DecisionDiag, PolicyParams,
                       admit_sequential, admit_sequential_verbose, decide,
                       decide_scored, geometric_grid, is_safe, make_policy,
                       tune_threshold)

__all__ = [
    "AZURE_PRIORS", "DeploymentParams", "PopulationPriors", "StepEvents",
    "sample_params", "sample_step_events", "scaleout_rate", "GammaBelief",
    "belief_from_prior", "observe_initial_size", "update_on_events",
    "MomentCurves", "aggregate_moment_curves", "masked_curve_reduction",
    "moment_curves", "moment_curves_fused", "ZEROTH", "FIRST", "SECOND",
    "DecisionDiag", "PolicyParams", "admit_sequential",
    "admit_sequential_verbose", "decide", "decide_scored", "geometric_grid",
    "is_safe", "make_policy", "tune_threshold",
]
