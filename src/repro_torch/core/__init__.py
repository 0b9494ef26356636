"""Moment-based cluster admission control (paper §2–§8), in PyTorch.

Public API (the ported part of ``repro.core``):
  processes  — deployment stochastic processes + fitted Azure priors
  belief     — conjugate Gamma belief state over scaling parameters
  moments    — closed-form E[L_t]/V[L_t] curves (continuous + paper-discrete)
               and aggregates
  policies   — zeroth/first/second moment policies, marginal heuristic
  pomdp      — the constrained-POMDP statement and tail bounds
  pricing    — variance-based payment rule / elicitation (Prop. 4)
"""
from .processes import (AZURE_PRIORS, DeploymentParams, PopulationPriors,
                        PseudoObservations, StepEvents, sample_initial_size,
                        sample_params, sample_pseudo_observations,
                        sample_step_events, scaleout_rate)
from .belief import (GammaBelief, apply_pseudo_observations,
                     belief_from_prior, observe_initial_size,
                     pseudo_counts_from_observables, update_on_events)
from .moments import (MomentCurves, aggregate_moment_curves,
                      masked_curve_reduction, moment_curves,
                      moment_curves_discrete, moment_curves_discrete_naive,
                      moment_curves_fused)
from .policies import (FIRST, SECOND, ZEROTH, DecisionDiag, PolicyParams,
                       admit_sequential, admit_sequential_verbose, decide,
                       decide_scored, fleet_policy, geometric_grid, is_safe,
                       make_policy, paper_cascade, tune_threshold)
from . import pomdp, pricing

__all__ = [
    "AZURE_PRIORS", "DeploymentParams", "PopulationPriors",
    "PseudoObservations", "StepEvents", "sample_params",
    "sample_step_events", "scaleout_rate", "sample_pseudo_observations",
    "sample_initial_size", "GammaBelief", "belief_from_prior",
    "update_on_events", "apply_pseudo_observations", "observe_initial_size",
    "pseudo_counts_from_observables", "MomentCurves",
    "aggregate_moment_curves", "masked_curve_reduction", "moment_curves",
    "moment_curves_discrete", "moment_curves_discrete_naive",
    "moment_curves_fused", "ZEROTH", "FIRST", "SECOND", "DecisionDiag",
    "PolicyParams", "admit_sequential", "admit_sequential_verbose", "decide",
    "decide_scored", "fleet_policy", "geometric_grid", "is_safe",
    "make_policy", "paper_cascade",
    "tune_threshold", "pomdp", "pricing",
]
