"""Device-side telemetry counters: the ``TelemetryState`` rider.

PyTorch counterpart of the JAX package's ``obs/counters.py``. The paper's
setting is *partial observability* — the provider decides from the observed
usage stream — and this module is the retained stream: a small NamedTuple
of counters, histograms and streaming sufficient statistics that rides in
``CoreState.tel`` through the ``AdmissionCore`` functions, ``make_run``'s
loop and the online engine's steps.

The rider is **off by default**: with ``SimConfig(telemetry=False)``
``CoreState.tel`` is ``None`` and no fold runs, so a step launches what it
launched before. On, every fold is a handful of float32 adds and histogram
scatters a step on the state's device, and decisions and metrics are
bit-identical either way (``tests/test_torch_telemetry.py``).

Layout, as in the JAX package: the scalar counters are packed into one
``[N_SCALARS]`` float32 vector (the ``I_*`` constants name the slots) plus
three histogram vectors. Every fold adds each counter's increment once, in
float32, so the counters carry the JAX package's bits for the same inputs.
With a run axis (``make_run`` on a batch of R runs) every leaf has a
leading ``[R]``; ``telemetry_summary`` reads one run's rider.

A sharded slot table (``sim.core.slot_mesh``) keeps the rider *replicated*
across its shards: every fold consumes slot-reduced values that the sharded
core computes from the gathered table on the mesh's first device, where the
one replica lives, so ``telemetry_summary`` reads that replica with no
cross-shard reduction (bit for bit the unsharded rider,
``tests/test_torch_mesh.py``).

Contents:

  * decision counters by reason — ``n_admit`` / ``n_reject_capacity`` (the
    request physically did not fit at decision time) / ``n_reject_policy``
    (it fit but the moment condition said no), and ``n_routed`` (the valid
    candidates decided);
  * ``occupancy_hist`` / ``headroom_hist`` — per-window utilization and
    headroom fractions over ``N_OCC_BINS`` equal bins of [0, 1];
  * ``staleness_hist`` — decisions bucketed by how many windows the
    maintained aggregate was stale at decision time (the
    ``agg_refresh_steps`` blocking made observable);
  * streaming sufficient statistics of the observables (``obs_*`` sums,
    the conjugate update's inputs) and of admitted arrivals (``arr_*`` —
    placed count, first/second moments of the initial request size).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device

F32 = torch.float32

#: occupancy/headroom histogram bins over the [0, 1] fraction range
N_OCC_BINS = 16
#: staleness histogram bins (windows since the last aggregate refresh;
#: larger values clip into the last bin)
N_STALENESS_BINS = 16

# scalar slots of TelemetryState.scalars; the decision block (I_N_ADMIT..
# I_N_ROUTED), the clock block (I_STEPS_SINCE_REFRESH, I_N_WINDOWS), the
# observables block (I_OBS_..I_OBS_DEPARTED) and the arrival block (I_ARR_..)
# are each contiguous, so a fold adds to each with one slice add
(I_N_ADMIT, I_N_REJECT_CAPACITY, I_N_REJECT_POLICY, I_N_ROUTED,
 I_N_REFRESHES, I_STEPS_SINCE_REFRESH, I_N_WINDOWS,
 I_OBS_CORE_DEATHS, I_OBS_EXPOSURE_CORE_HOURS, I_OBS_N_SCALEOUTS,
 I_OBS_SCALEOUT_CORES, I_OBS_ALIVE_HOURS, I_OBS_SPONT_DEATHS,
 I_OBS_DEPARTED, I_ARR_PLACED, I_ARR_C0_SUM, I_ARR_C0_SUMSQ) = range(17)
N_SCALARS = 17


class WindowStats(NamedTuple):
    """One ``dt``-window's observable sufficient statistics for a cluster —
    the sums of everything ``core.belief.update_on_events`` consumes (plus
    departures), made by the core's event step only when telemetry is on.
    0-d float32 tensors ([R] with a run axis)."""

    core_deaths: torch.Tensor          # total cores lost to deaths
    exposure_core_hours: torch.Tensor  # total core-hour exposure
    n_scaleouts: torch.Tensor          # total scale-out requests
    scaleout_cores: torch.Tensor       # total cores requested by scale-outs
    alive_hours: torch.Tensor          # total deployment-hours alive
    spont_deaths: torch.Tensor         # spontaneous whole-deployment shutdowns
    departed: torch.Tensor             # deployments that left (any cause)


class TelemetryState(NamedTuple):
    """Device-resident telemetry accumulators (float32; a leading ``[R]``
    with a run axis)."""

    scalars: torch.Tensor          # [N_SCALARS], slots named by I_*
    staleness_hist: torch.Tensor   # [N_STALENESS_BINS] decisions by staleness
    occupancy_hist: torch.Tensor   # [N_OCC_BINS] windows by util/capacity
    headroom_hist: torch.Tensor    # [N_OCC_BINS] windows by 1 - util/capacity

    # -- named views over the packed vector -------------------------------
    @property
    def n_admit(self) -> torch.Tensor:
        return self.scalars[..., I_N_ADMIT]

    @property
    def n_routed(self) -> torch.Tensor:
        return self.scalars[..., I_N_ROUTED]

    @property
    def n_refreshes(self) -> torch.Tensor:
        return self.scalars[..., I_N_REFRESHES]

    @property
    def n_windows(self) -> torch.Tensor:
        return self.scalars[..., I_N_WINDOWS]

    @property
    def steps_since_refresh(self) -> torch.Tensor:
        return self.scalars[..., I_STEPS_SINCE_REFRESH]


def init_telemetry(runs=None, device="cuda") -> TelemetryState:
    """A fresh all-zero rider on ``device`` (the card unless the caller
    passes ``"cpu"``; raises when CUDA is missing), every leaf a distinct
    tensor: of one run, of ``runs`` runs (a leading axis), or with the
    leading axes of a tuple ``runs`` ((C,) for a fleet, (R, C) for R fleet
    runs)."""
    device = resolve_device(device)
    if runs is None:
        lead = ()
    else:
        lead = tuple(runs) if isinstance(runs, tuple) else (int(runs),)
    zeros = lambda n: torch.zeros((*lead, n), dtype=F32, device=device)
    return TelemetryState(scalars=zeros(N_SCALARS),
                          staleness_hist=zeros(N_STALENESS_BINS),
                          occupancy_hist=zeros(N_OCC_BINS),
                          headroom_hist=zeros(N_OCC_BINS))


def _hist_bin(frac: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bin index of a [0, 1] fraction (out-of-range clips to the edges)."""
    return torch.clamp(torch.floor(frac * n_bins).to(torch.int64), 0,
                       n_bins - 1)


def _hist_add(hist: torch.Tensor, idx: torch.Tensor,
              value: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``hist`` with ``value`` (one if None) added at bin ``idx`` (per
    run)."""
    if value is None:
        value = torch.ones(idx.shape, dtype=F32, device=hist.device)
    return hist.scatter_add(-1, idx[..., None], value[..., None])


def mark_refresh(tel: TelemetryState) -> TelemetryState:
    """Record a full aggregate recompute: staleness returns to zero."""
    s = tel.scalars.clone()
    s[..., I_N_REFRESHES] += 1.0
    s[..., I_STEPS_SINCE_REFRESH] = 0.0
    return tel._replace(scalars=s)


def fold_window(tel: TelemetryState, util: torch.Tensor, capacity,
                stats: Optional[WindowStats]) -> TelemetryState:
    """Fold one window of events: occupancy/headroom histograms, the
    staleness clock, and the window's observable sufficient statistics.
    ``capacity`` (a number, or a fleet's [C] tensor) divides as a tensor:
    CUDA divides by a Python number as a multiply by its reciprocal."""
    frac = util / torch.as_tensor(capacity, dtype=F32, device=util.device)
    occ = _hist_add(tel.occupancy_hist, _hist_bin(frac, N_OCC_BINS))
    head = _hist_add(tel.headroom_hist, _hist_bin(1.0 - frac, N_OCC_BINS))
    s = tel.scalars.clone()
    s[..., I_STEPS_SINCE_REFRESH:I_N_WINDOWS + 1] += 1.0
    if stats is not None:
        s[..., I_OBS_CORE_DEATHS:I_OBS_DEPARTED + 1] += torch.stack(
            tuple(stats), dim=-1)
    return tel._replace(scalars=s, occupancy_hist=occ, headroom_hist=head)


def fold_decisions(tel: TelemetryState, accept: torch.Tensor,
                   valid: torch.Tensor, fits: torch.Tensor,
                   placed: torch.Tensor, c0: torch.Tensor) -> TelemetryState:
    """Fold one decision batch: reason counters, the staleness histogram,
    and the admitted-arrival stream moments.

    ``accept``/``valid``/``fits``/``placed`` are ``[A]`` masks (``fits`` is
    the physical-fit flag *at each candidate's decision point* from
    ``admit_sequential_verbose``); ``accept`` already implies ``valid``. A
    candidate failing both the capacity fit and the moment condition counts
    as ``n_reject_capacity`` — the physical constraint dominates.
    """
    total = lambda mask: torch.sum(mask.to(F32), dim=-1)
    rej = valid & ~accept
    n_valid = total(valid)
    placed_f = placed.to(F32)
    stale_bin = torch.clamp(tel.scalars[..., I_STEPS_SINCE_REFRESH] - 1.0,
                            0.0, float(N_STALENESS_BINS - 1)).to(torch.int64)
    s = tel.scalars.clone()
    s[..., I_N_ADMIT:I_N_ROUTED + 1] += torch.stack(
        [total(accept), total(rej & ~fits), total(rej & fits), n_valid],
        dim=-1)
    s[..., I_ARR_PLACED:I_ARR_C0_SUMSQ + 1] += torch.stack(
        [torch.sum(placed_f, dim=-1), torch.sum(placed_f * c0, dim=-1),
         torch.sum(placed_f * c0 * c0, dim=-1)], dim=-1)
    return tel._replace(
        scalars=s,
        staleness_hist=_hist_add(tel.staleness_hist, stale_bin, n_valid))


def telemetry_summary(tel: TelemetryState) -> dict:
    """Host-side summary dict of one run's rider: scalar counters as
    floats, histograms as lists, plus derived means, with the JAX
    package's keys. A fleet's rider ([C]-leading leaves) is summed over the
    clusters in float32 (as the JAX package sums it), with each cluster's
    ``n_routed`` and ``n_admit`` kept under ``per_cluster``. A batch's
    rider: pass one run's leaves, ``TelemetryState(*(x[r] for x in
    tel))``."""
    if tel.scalars.ndim not in (1, 2):
        raise ValueError(f"telemetry_summary reads one run's rider (one "
                         f"cluster or a fleet); got scalars "
                         f"{tuple(tel.scalars.shape)}")
    host = TelemetryState(*(x.detach().cpu().numpy() for x in tel))
    fleet = host.scalars.ndim == 2
    agg = (TelemetryState(*(np.sum(x, axis=0) for x in host)) if fleet
           else host)
    s = agg.scalars
    placed = float(s[I_ARR_PLACED])
    mean_c0 = float(s[I_ARR_C0_SUM]) / placed if placed else 0.0
    var_c0 = (float(s[I_ARR_C0_SUMSQ]) / placed - mean_c0 ** 2) if placed \
        else 0.0
    out = {
        "n_admit": float(s[I_N_ADMIT]),
        "n_reject_capacity": float(s[I_N_REJECT_CAPACITY]),
        "n_reject_policy": float(s[I_N_REJECT_POLICY]),
        "n_routed": float(s[I_N_ROUTED]),
        "n_refreshes": float(s[I_N_REFRESHES]),
        "n_windows": float(s[I_N_WINDOWS]),
        "staleness_hist": agg.staleness_hist.tolist(),
        "occupancy_hist": agg.occupancy_hist.tolist(),
        "headroom_hist": agg.headroom_hist.tolist(),
        "obs": {
            "core_deaths": float(s[I_OBS_CORE_DEATHS]),
            "exposure_core_hours": float(s[I_OBS_EXPOSURE_CORE_HOURS]),
            "n_scaleouts": float(s[I_OBS_N_SCALEOUTS]),
            "scaleout_cores": float(s[I_OBS_SCALEOUT_CORES]),
            "alive_hours": float(s[I_OBS_ALIVE_HOURS]),
            "spont_deaths": float(s[I_OBS_SPONT_DEATHS]),
            "departed": float(s[I_OBS_DEPARTED]),
        },
        "arr_placed": placed,
        "arr_c0_mean": mean_c0,
        "arr_c0_var": max(var_c0, 0.0),
    }
    if fleet:
        out["per_cluster"] = {
            "n_routed": host.scalars[:, I_N_ROUTED].tolist(),
            "n_admit": host.scalars[:, I_N_ADMIT].tolist(),
        }
    return out
