"""The paper's own simulation setting (§5.2) as canonical presets.

``PAPER_FULL`` is the exact published configuration (c=20,000, 1 arrival/h,
3-year horizon, SLA 0.01%). ``PAPER_CPU`` is the down-scale the JAX
package's default benchmarks use, keeping the paper's regime (cluster much
larger than any deployment). Both use the fitted Azure priors of Table 1.
``TRACE_FULL`` and ``TRACE_CPU`` are their synthetic-trace counterparts.
"""
from ..core.processes import AZURE_PRIORS
from ..sim.core import SimConfig
from ..traces.synth import TraceSpec

#: paper §5.2, verbatim scale
PAPER_FULL = SimConfig(
    capacity=20_000.0,
    arrival_rate=1.0,
    horizon_hours=3 * 365 * 24.0,
    dt=6.0,
    max_slots=8192,
    max_arrivals=8,
    priors=AZURE_PRIORS,
)

#: the paper's regime at a smaller cluster
PAPER_CPU = SimConfig(
    capacity=2_500.0,
    arrival_rate=0.125,
    horizon_hours=1.25 * 365 * 24.0,
    dt=12.0,
    max_slots=768,
    max_arrivals=5,
    priors=AZURE_PRIORS,
)

#: synthetic-trace counterparts of the presets (repro_torch.traces): capacity
#: is sized ~2x the expected arrival count so bursty scenarios (flash crowds)
#: never clip against the columnar buffer.
TRACE_FULL = TraceSpec(
    horizon_hours=PAPER_FULL.horizon_hours,
    arrival_rate=PAPER_FULL.arrival_rate,
    max_deployments=65_536,
    max_events=32,
    priors=AZURE_PRIORS,
)

TRACE_CPU = TraceSpec(
    horizon_hours=PAPER_CPU.horizon_hours,
    arrival_rate=PAPER_CPU.arrival_rate,
    max_deployments=4_096,
    max_events=16,
    priors=AZURE_PRIORS,
)

#: paper §5.2 tuned thresholds at full scale (Table 2) — reference points
PAPER_TABLE2 = {
    "zeroth_threshold": 8_864.0,
    "first_threshold": 14_223.0,
    "second_rho": 0.112,
    "utilization": {"zeroth": 0.5045, "first": 0.6619, "second": 0.6732},
    "sla": 1e-4,
}
