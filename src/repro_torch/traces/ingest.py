"""Cortez/Azure-format trace ingestion: VM-level CSV -> ``WorkloadTrace``.

The paper grounds its Table-1 priors in the Azure trace of Cortez et
al. [2017] (the AzurePublicDataset "VM table"): one row per VM with a
deployment id, create/delete timestamps in seconds, and a bucketed core
count. ``ingest_cortez_csv`` converts that row format into the repo's
columnar ``WorkloadTrace`` so ``fit_priors(source="observed")`` and trace
replay run on real data:

  * **schema mapping** — ``CortezSchema`` names the columns either by
    header name (the dataset's published schema) or by position (the raw
    files ship headerless); ``AZURE_2017_POSITIONAL`` matches the original
    11-column layout.
  * **unit normalization** — timestamps are converted from the source unit
    (seconds by default) to hours and origin-shifted so the first VM
    creation is t = 0; bucketed core counts parse ``"1"``/``"4"`` and the
    open bucket ``">24"`` (taken at its lower bound times
    ``open_bucket_scale``).
  * **dt re-bucketing** — ``rebucket_dt_hours`` optionally snaps all
    timestamps down to a coarser grid (the raw 5-minute resolution is far
    below any simulator ``dt``); VMs created within
    ``c0_window_hours`` of their deployment's first creation fold into the
    initial request C0 instead of registering as instant scale-outs.
  * **malformed-row accounting** — rows with missing fields, unparsable
    numbers, negative times, or deletion-before-creation are counted in
    the diagnostics (``n_malformed``) and skipped, never silently guessed.

Model mapping (paper §2.1): a deployment's arrival is its first VM
creation; later VM creations are scale-out events; a VM deletion before
the deployment's last is a core death (the deletion of the final VM(s) is
the deployment's spontaneous shutdown, the paper's M process, not a core
death); deployments whose last VM outlives the trace are right-censored.
Latent columns (lam, mu, sig) are NaN — real traces carry observables
only — so replay imputes conjugate posterior means and
``fit_priors(source="observed")`` is the fitting path.

PyTorch counterpart of ``repro.traces.ingest``: the same host parsing, the
finished columns moved to the caller's device once.
"""
from __future__ import annotations

import csv
import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .schema import ScaleoutEvents, WorkloadTrace, validate_trace

Column = Union[str, int]

SECONDS_PER_HOUR = 3600.0


class CortezSchema(NamedTuple):
    """Column mapping for a Cortez-format VM table.

    Each field is a header name (str) or a 0-based position (int); a file
    is read positionally when every field is an int, otherwise its first
    row must be a header containing every named column.
    """

    vm_id: Column = "vmid"
    deployment_id: Column = "deploymentid"
    created: Column = "vmcreated"
    deleted: Column = "vmdeleted"
    cores: Column = "vmcorecountbucket"
    time_unit_seconds: float = 1.0   # raw timestamp unit, in seconds


#: The original AzurePublicDataset 2017 vmtable.csv layout (headerless):
#: vmid, subscriptionid, deploymentid, vmcreated, vmdeleted, maxcpu,
#: avgcpu, p95maxcpu, vmcategory, vmcorecountbucket, vmmemorybucket.
AZURE_2017_POSITIONAL = CortezSchema(vm_id=0, deployment_id=2, created=3,
                                     deleted=4, cores=9)


def parse_core_bucket(cell: str, open_bucket_scale: float = 1.0) -> float:
    """Parse a core-count cell: plain numbers plus the ``">24"`` open
    bucket, valued at its lower bound times ``open_bucket_scale``."""
    cell = cell.strip()
    if cell.startswith(">"):
        return float(cell[1:]) * open_bucket_scale
    return float(cell)


class _VMRow(NamedTuple):
    dep: str
    created: float    # hours since trace origin
    deleted: float    # hours; +inf when censored (empty/missing cell)
    cores: float


def _resolve_columns(schema: CortezSchema, first_row: list[str]
                     ) -> tuple[dict, bool]:
    """Map schema fields to column indices; returns (mapping, has_header)."""
    named = {f: c for f, c in zip(schema._fields, schema)
             if isinstance(c, str)}
    if not named:
        return {f: int(getattr(schema, f)) for f in
                ("vm_id", "deployment_id", "created", "deleted", "cores")}, \
            False
    header = [c.strip().lower() for c in first_row]
    idx = {}
    for field in ("vm_id", "deployment_id", "created", "deleted", "cores"):
        col = getattr(schema, field)
        if isinstance(col, int):
            idx[field] = col
            continue
        try:
            idx[field] = header.index(col.lower())
        except ValueError:
            raise ValueError(
                f"column {col!r} (schema field {field!r}) not found in "
                f"header {first_row!r}; for headerless files use a "
                "positional schema such as AZURE_2017_POSITIONAL")
    return idx, True


def _parse_rows(path: str, schema: CortezSchema, open_bucket_scale: float,
                diag: dict) -> list[_VMRow]:
    """Read and normalize the VM rows; malformed rows counted, not kept."""
    to_hours = schema.time_unit_seconds / SECONDS_PER_HOUR
    rows: list[_VMRow] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            first = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty trace file")
        idx, has_header = _resolve_columns(schema, first)
        n_cols = max(idx.values()) + 1
        raw = [] if has_header else [first]
        raw.extend(reader)
    diag["has_header"] = has_header
    diag["n_rows"] = len(raw)
    n_bad = 0
    for row in raw:
        if len(row) < n_cols:
            n_bad += 1
            continue
        try:
            dep = row[idx["deployment_id"]].strip()
            created = float(row[idx["created"]]) * to_hours
            del_cell = row[idx["deleted"]].strip()
            deleted = (math.inf if del_cell == ""
                       else float(del_cell) * to_hours)
            cores = parse_core_bucket(row[idx["cores"]], open_bucket_scale)
        except ValueError:
            n_bad += 1
            continue
        if (not dep or not math.isfinite(created) or created < 0.0
                or deleted < created or not (math.isfinite(cores)
                                             and cores > 0.0)
                or math.isnan(deleted)):
            n_bad += 1
            continue
        rows.append(_VMRow(dep, created, deleted, cores))
    diag["n_malformed"] = n_bad
    diag["n_vms"] = len(rows)
    if not rows:
        raise ValueError(
            f"{path}: no well-formed VM rows "
            f"({n_bad} malformed out of {len(raw)})")
    return rows


def ingest_cortez_csv(
    path: str,
    *,
    schema: CortezSchema = CortezSchema(),
    horizon_hours: Optional[float] = None,
    max_deployments: Optional[int] = None,
    max_events: int = 16,
    rebucket_dt_hours: float = 0.0,
    c0_window_hours: Optional[float] = None,
    open_bucket_scale: float = 1.0,
    device="cuda",
) -> tuple[WorkloadTrace, dict]:
    """Convert a Cortez/Azure-format VM CSV into a ``WorkloadTrace``.

    Returns ``(trace, diagnostics)``. ``horizon_hours`` defaults to the
    last observed event (after origin shift); VMs arriving beyond an
    explicit horizon are dropped (counted in ``n_vms_beyond_horizon``).
    ``c0_window_hours`` (default: ``rebucket_dt_hours``) folds VM
    creations that close to the deployment's first into the initial
    request C0. The trace's columns are on ``device`` (the card unless the
    caller passes ``"cpu"``). See the module docstring for the full model
    mapping.
    """
    device = resolve_device(device)
    dev = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    diag: dict = {"path": path}
    rows = _parse_rows(path, schema, open_bucket_scale, diag)

    t0 = min(r.created for r in rows)
    if rebucket_dt_hours > 0.0:
        snap = lambda t: (math.floor((t - t0) / rebucket_dt_hours)
                          * rebucket_dt_hours if math.isfinite(t)
                          else math.inf)
    else:
        snap = lambda t: t - t0
    rows = [r._replace(created=snap(r.created), deleted=snap(r.deleted))
            for r in rows]
    data_end = max(max(r.created for r in rows),
                   max((r.deleted for r in rows if math.isfinite(r.deleted)),
                       default=0.0))
    horizon = data_end if horizon_hours is None else float(horizon_hours)
    horizon = max(horizon, 1e-9)
    c0_win = rebucket_dt_hours if c0_window_hours is None else c0_window_hours
    diag["t0_hours_raw"] = t0
    diag["horizon_hours"] = horizon

    by_dep: dict[str, list[_VMRow]] = {}
    n_beyond = 0
    for r in rows:
        if r.created >= horizon:
            n_beyond += 1
            continue
        by_dep.setdefault(r.dep, []).append(r)
    diag["n_vms_beyond_horizon"] = n_beyond

    deps = sorted(by_dep.values(), key=lambda ms: min(m.created for m in ms))
    n_found = len(deps)
    cap = n_found if max_deployments is None else int(max_deployments)
    diag["n_deployments"] = min(n_found, cap)
    diag["n_deployments_dropped"] = max(n_found - cap, 0)
    deps = deps[:cap]
    d = max(len(deps), 1)
    e = max(max_events, 1)

    cols = {k: np.zeros(d, np.float32) for k in
            ("arrival_hours", "c0", "obs_window", "n_core_deaths",
             "core_hours", "n_scaleouts", "scaleout_cores")}
    spont = np.zeros(d, bool)
    ev_t = np.zeros((d, e), np.float32)
    ev_c = np.zeros((d, e), np.float32)
    ev_v = np.zeros((d, e), bool)
    n_tail_events = 0

    for i, members in enumerate(deps):
        members = sorted(members, key=lambda m: m.created)
        arrival = members[0].created
        end = max(m.deleted for m in members)        # inf when censored
        spont_i = math.isfinite(end) and end < horizon
        window_end = min(end, horizon)

        c0 = deaths = core_hours = so_n = so_cores = 0.0
        n_ev = 0
        for m in members:
            life_end = min(m.deleted, horizon)
            core_hours += m.cores * max(life_end - m.created, 0.0)
            is_initial = m.created <= arrival + c0_win
            if is_initial:
                c0 += m.cores
            else:
                so_n += 1.0
                so_cores += m.cores
                if n_ev < e:
                    ev_t[i, n_ev] = m.created - arrival
                    ev_c[i, n_ev] = m.cores
                    ev_v[i, n_ev] = True
                    n_ev += 1
                else:
                    n_tail_events += 1
            # a deletion strictly before the deployment's end is a core
            # death; deletions at the end are the spontaneous shutdown
            # (or censoring), the M process, not the death process
            if math.isfinite(m.deleted) and m.deleted < window_end:
                deaths += m.cores

        cols["arrival_hours"][i] = arrival
        cols["c0"][i] = max(c0, 1.0)
        cols["obs_window"][i] = max(window_end - arrival, 0.0)
        cols["n_core_deaths"][i] = deaths
        cols["core_hours"][i] = core_hours
        cols["n_scaleouts"][i] = so_n
        cols["scaleout_cores"][i] = so_cores
        spont[i] = spont_i
    diag["n_events_beyond_buffer"] = n_tail_events

    valid = np.zeros(d, bool)
    valid[:len(deps)] = True
    nan = np.full(d, np.nan, np.float32)
    trace = WorkloadTrace(
        arrival_hours=dev(cols["arrival_hours"]),
        c0=dev(cols["c0"]),
        valid=dev(valid),
        lam=dev(nan), mu=dev(nan), sig=dev(nan),
        obs_window=dev(cols["obs_window"]),
        spont_death=dev(spont),
        n_core_deaths=dev(cols["n_core_deaths"]),
        core_hours=dev(cols["core_hours"]),
        n_scaleouts=dev(cols["n_scaleouts"]),
        scaleout_cores=dev(cols["scaleout_cores"]),
        events=ScaleoutEvents(t_offset=dev(ev_t),
                              cores=dev(ev_c),
                              valid=dev(ev_v)),
        horizon_hours=dev(np.float32(horizon)),
    )
    return validate_trace(trace), diag
