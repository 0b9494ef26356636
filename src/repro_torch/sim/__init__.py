"""Monte-Carlo cluster simulation (paper §5), in PyTorch: the admission core,
the single-cluster ``make_run`` loop over it (one run or a batch of runs),
and the run metrics (BCa intervals, SLA accounting)."""
from .core import (AGG_FUSED, AGG_KERNEL, AGG_REFERENCE, GLOBAL, MIX_LABELED,
                   MIX_UNLABELED, PSEUDO, AdmissionCore, ArrivalSource,
                   ArrivalStream, CoreState, PriorArrivalSource, SimConfig,
                   SimState, StepOutcome, draw_arrival_stream,
                   make_admission_core, make_config)
from .metrics import (CI, bca_ci, fleet_sla_failure_rate, fleet_utilization,
                      sla_failure_rate, weighted_mean)
from .simulator import (RunMetrics, make_run, run_batch, run_keyed_batch,
                        split_seeds)

__all__ = [
    "AGG_FUSED", "AGG_KERNEL", "AGG_REFERENCE", "GLOBAL", "MIX_LABELED",
    "MIX_UNLABELED", "PSEUDO", "AdmissionCore", "ArrivalSource",
    "ArrivalStream", "CI", "CoreState", "PriorArrivalSource", "RunMetrics",
    "SimConfig", "SimState", "StepOutcome", "bca_ci", "draw_arrival_stream",
    "fleet_sla_failure_rate", "fleet_utilization", "make_admission_core",
    "make_config", "make_run", "run_batch", "run_keyed_batch",
    "sla_failure_rate", "split_seeds", "weighted_mean",
]
