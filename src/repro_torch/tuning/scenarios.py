"""Per-scenario threshold re-tuning over the trace scenario registry.

The scenario sweep replays *stationary-tuned* policies under non-stationary
traces on purpose — that measures robustness. This module is the other
half: re-tune each policy **against the scenario's own arrivals** at the
same SLA target, so the robustness gap (stationary-tuned vs re-tuned
utilization at matched SLA) is measured rather than implied.

``replay_stream_batch`` synthesizes a per-run trace ensemble for a scenario
and stacks the replay streams; ``calibrate_scenario`` evaluates the
stationary parameter and runs a full ``tuning.calibrate`` on those exact
streams — same run seeds, same arrivals, only the parameter differs.

PyTorch counterpart of ``repro.tuning.scenarios``: seeds where the JAX
package splits keys (``sim.split_seeds``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..sim.core import ArrivalStream, SimConfig
from ..sim.simulator import _tree_map, split_seeds
from ..traces import synthesize_scenario, trace_to_stream
from .calibrate import CalibrationResult, calibrate, eval_theta_grid, sla_ci


def replay_stream_batch(trace_seed: int, run_seed: int, scenario: str, spec,
                        cfg: SimConfig, n_runs: int, *, device="cuda"):
    """One scenario -> a stacked [R] replay-stream batch plus [R] run seeds,
    on ``device`` (the card unless the caller passes ``"cpu"``).

    Each run gets its own synthesized trace (an iid draw of the scenario's
    arrival process, seeded by ``split_seeds(trace_seed, n_runs)``) so the
    batch estimates the scenario's population, not a single trace. Run
    seeds come from a distinct root (``split_seeds(run_seed, n_runs)``):
    within-run randomness (deaths, scale-out timing) must not correlate
    with the replayed arrivals. Returns ``(streams, run_seeds, n_dropped)``
    — dropped counts arrivals lost to the per-step ``cfg.max_arrivals``
    cap, summed over the batch.
    """
    device = resolve_device(device)
    streams, dropped = [], 0
    for ts in split_seeds(trace_seed, n_runs):
        s, n_drop = trace_to_stream(
            synthesize_scenario(ts, scenario, spec, device=device), cfg)
        streams.append(s)
        dropped += int(n_drop)
    stacked = _tree_map(lambda *xs: torch.stack(xs), *streams)
    return stacked, split_seeds(run_seed, n_runs), dropped


@dataclasses.dataclass(frozen=True)
class ScenarioCalibration:
    """Stationary-tuned vs re-tuned operating points on identical arrivals."""

    scenario: str
    kind: int
    stationary_theta: float
    stationary_util: float
    stationary_sla: float     # aggregate failure rate at the stationary theta
    retuned: CalibrationResult

    @property
    def util_gap(self) -> float:
        """Re-tuned minus stationary utilization: what re-tuning buys (or,
        when the stationary theta was SLA-violating under this scenario,
        what honoring the SLA costs)."""
        return self.retuned.utilization - self.stationary_util


def calibrate_scenario(
    run_fn,
    kind: int,
    scenario: str,
    streams: ArrivalStream,
    run_keys,
    *,
    capacity: float,
    tau: float,
    stationary_theta: float,
    n_grid: int = 8,
    max_stages: int = 2,
    marginal: bool = False,
    devices=None,
) -> ScenarioCalibration:
    """Measure the robustness gap for one (scenario, policy kind) pair.

    Evaluates the stationary-tuned ``stationary_theta`` and a full SLA
    re-calibration on the **same** stacked replay streams and run seeds
    (``run_keys``), so the two operating points differ only in the
    parameter. ``run_fn`` must be built for the replay config the streams
    were made with.
    """
    m = eval_theta_grid(run_fn, kind, [stationary_theta], run_keys,
                        capacity=capacity, marginal=marginal, streams=streams,
                        devices=devices)
    fails = m.failed_requests[0].cpu().numpy()
    reqs = m.total_requests[0].cpu().numpy()
    stat_sla, _, _ = sla_ci(fails, reqs)
    stat_util = float(np.mean(m.utilization[0].cpu().numpy()))

    retuned = calibrate(run_fn, kind, run_keys, capacity=capacity, tau=tau,
                        n_grid=n_grid, max_stages=max_stages,
                        marginal=marginal, streams=streams, devices=devices)
    return ScenarioCalibration(
        scenario=scenario, kind=kind,
        stationary_theta=float(stationary_theta),
        stationary_util=stat_util, stationary_sla=float(stat_sla),
        retuned=retuned,
    )
