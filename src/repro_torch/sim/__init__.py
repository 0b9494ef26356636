"""Monte-Carlo cluster simulation (paper §5), in PyTorch: the admission core,
the single-cluster ``make_run`` loop over it (one run or a batch of runs),
the routed multi-cluster fleet (``make_fleet_run`` and the routers of
``sim.routing``), and the run metrics (BCa intervals, SLA accounting). One
cluster's slot table may be sharded over a device mesh (``slot_mesh``), and
a batch of runs split over devices (``run_keyed_batch(..., devices=)``).
Arrivals' priors follow ``SimConfig.prior_mode``: GLOBAL, PSEUDO (§6) or
the §7 type mixtures MIX_LABELED and MIX_UNLABELED. Appendix D's importance
sampling (``sim.importance``) buckets runs, or replayed traces, by their
badness measure."""
from .core import (AGG_FUSED, AGG_KERNEL, AGG_REFERENCE, GLOBAL, MIX_LABELED,
                   MIX_UNLABELED, PSEUDO, AdmissionCore, ArrivalSource,
                   ArrivalStream, CoreState, FleetConfig, PriorArrivalSource,
                   SimConfig, SimState, StepOutcome, draw_arrival_stream,
                   make_admission_core, make_config, make_fleet_config,
                   slot_mesh, stream_config)
from .metrics import (CI, bca_ci, fleet_sla_failure_rate, fleet_utilization,
                      sla_failure_rate, weighted_mean)
from .routing import (ROUTERS, LeastUtilizedRouter, PowerOfTwoRouter,
                      RandomRouter, RouteContext, Router,
                      ThresholdCascadeRouter)
from .importance import (ImportancePlan, TraceEnsemblePlan, badness_measure,
                         estimate_from_plan, make_importance_plan,
                         make_trace_ensemble_plan, plan_from_badness,
                         rejection_q, simulate_plan, simulate_trace_plan,
                         stream_badness, trace_plan_from_badness)
from .simulator import (FleetMetrics, RunMetrics, broadcast_policy,
                        fleet_generators, make_fleet_run, make_run, run_batch,
                        run_keyed_batch, split_seeds)

__all__ = [
    "AGG_FUSED", "AGG_KERNEL", "AGG_REFERENCE", "GLOBAL", "MIX_LABELED",
    "MIX_UNLABELED", "PSEUDO", "AdmissionCore", "ArrivalSource",
    "ArrivalStream", "CI", "CoreState", "FleetConfig", "FleetMetrics",
    "LeastUtilizedRouter", "PowerOfTwoRouter", "PriorArrivalSource",
    "ROUTERS", "RandomRouter", "RouteContext", "Router", "RunMetrics",
    "SimConfig", "SimState", "StepOutcome", "ThresholdCascadeRouter",
    "bca_ci", "broadcast_policy", "draw_arrival_stream",
    "fleet_generators", "fleet_sla_failure_rate", "fleet_utilization",
    "make_admission_core", "make_config", "make_fleet_config",
    "make_fleet_run", "make_run", "run_batch", "run_keyed_batch",
    "sla_failure_rate", "slot_mesh", "split_seeds", "stream_config",
    "weighted_mean",
    "ImportancePlan", "TraceEnsemblePlan", "badness_measure",
    "estimate_from_plan", "make_importance_plan", "make_trace_ensemble_plan",
    "plan_from_badness", "rejection_q", "simulate_plan",
    "simulate_trace_plan", "stream_badness", "trace_plan_from_badness",
]
