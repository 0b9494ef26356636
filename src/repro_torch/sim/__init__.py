"""Monte-Carlo cluster simulation (paper §5), in PyTorch: the admission core
and the single-cluster ``make_run`` loop over it."""
from .core import (AGG_FUSED, AGG_KERNEL, AGG_REFERENCE, GLOBAL, MIX_LABELED,
                   MIX_UNLABELED, PSEUDO, AdmissionCore, ArrivalSource,
                   ArrivalStream, CoreState, PriorArrivalSource, SimConfig,
                   SimState, StepOutcome, draw_arrival_stream,
                   make_admission_core, make_config)
from .simulator import RunMetrics, make_run

__all__ = [
    "AGG_FUSED", "AGG_KERNEL", "AGG_REFERENCE", "GLOBAL", "MIX_LABELED",
    "MIX_UNLABELED", "PSEUDO", "AdmissionCore", "ArrivalSource",
    "ArrivalStream", "CoreState", "PriorArrivalSource", "RunMetrics",
    "SimConfig", "SimState", "StepOutcome", "draw_arrival_stream",
    "make_admission_core", "make_config", "make_run",
]
