"""Columnar workload-trace schema + CSV/NPZ persistence.

A ``WorkloadTrace`` is the trace-driven counterpart of the paper's Azure
trace (Cortez et al. [2017]): one row per deployment, fixed-capacity columns
(``max_deployments`` rows, ``valid`` mask for the unused tail). Columns split
into three groups:

  * arrival stream     — ``arrival_hours`` (sorted), ``c0``, ``valid``
  * latent parameters  — ``lam``/``mu``/``sig`` per deployment; NaN when the
    trace came from real observations rather than a generator
  * observables        — what a provider actually logs: the observation
    window (censored at spontaneous shutdown / horizon), core-death counts
    and core-hour exposure, scale-out counts and total requested cores, and
    a per-deployment scale-out *event stream* (first ``max_events`` events;
    the scalar totals are authoritative beyond the buffer)

``fit.py`` recovers ``PopulationPriors`` from either group; ``replay.py``
turns any trace into the simulator's pre-drawn ``ArrivalStream``.

PyTorch counterpart of ``repro.traces.schema``: the columns are tensors on
one device. ``validate_trace`` reads the columns on the host, so it runs
once when a trace is built or loaded, never inside a step. The file formats
are the JAX package's, so each package reads what the other wrote.

Persistence: ``save_npz``/``load_npz`` are lossless. ``save_csv`` writes two
human-readable tables (``<path>`` deployments, ``<path>.events.csv`` event
stream) holding only valid rows, so a CSV round-trip compacts the trace.
"""
from __future__ import annotations

import csv
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class ScaleoutEvents(NamedTuple):
    """Per-deployment scale-out event buffer. All fields [D, E]-shaped."""

    t_offset: torch.Tensor   # hours since the deployment's arrival
    cores: torch.Tensor      # cores requested by the event
    valid: torch.Tensor      # bool; first min(n_scaleouts, E) events are real


class WorkloadTrace(NamedTuple):
    """One workload trace: [D] deployment columns + [D, E] event buffer."""

    arrival_hours: torch.Tensor   # [D] sorted arrival times (hours)
    c0: torch.Tensor              # [D] initial core request
    valid: torch.Tensor           # [D] bool — row holds a real deployment
    # latent parameters (synthetic traces; NaN when unknown)
    lam: torch.Tensor             # [D]
    mu: torch.Tensor              # [D]
    sig: torch.Tensor             # [D]
    # observables over the deployment's observation window
    obs_window: torch.Tensor      # [D] hours observed (censored)
    spont_death: torch.Tensor     # [D] bool — window ended by spontaneous death
    n_core_deaths: torch.Tensor   # [D] core deaths observed in the window
    core_hours: torch.Tensor      # [D] core-hour exposure behind those deaths
    n_scaleouts: torch.Tensor     # [D] scale-out events (may exceed the buffer)
    scaleout_cores: torch.Tensor  # [D] total cores across all scale-outs
    events: ScaleoutEvents        # [D, E] first max_events events
    horizon_hours: torch.Tensor   # 0-d — trace duration


def host(x) -> np.ndarray:
    """A column as a numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace_to(trace: WorkloadTrace, device) -> WorkloadTrace:
    """The same trace with every column on ``device``."""
    device = resolve_device(device)
    move = lambda x: torch.as_tensor(x).to(device)
    return WorkloadTrace(
        **{k: move(v) for k, v in trace._asdict().items() if k != "events"},
        events=ScaleoutEvents(*map(move, trace.events)))


def host_trace(trace: WorkloadTrace) -> WorkloadTrace:
    """The same trace with every column a numpy array on the host: read
    once, then windowed or fitted any number of times."""
    return WorkloadTrace(
        **{k: host(v) for k, v in trace._asdict().items() if k != "events"},
        events=ScaleoutEvents(*map(host, trace.events)))


def n_deployments(trace: WorkloadTrace) -> int:
    """Number of valid deployments (reads the mask on the host)."""
    return int(host(trace.valid).sum())


def has_latents(trace: WorkloadTrace) -> bool:
    """True when every valid row carries finite latent parameters."""
    v = host(trace.valid)
    if not v.any():
        return False
    ok = (np.isfinite(host(trace.lam)) & np.isfinite(host(trace.mu))
          & np.isfinite(host(trace.sig)))
    return bool(ok[v].all())


def validate_trace(trace: WorkloadTrace) -> WorkloadTrace:
    """Shape/ordering sanity checks; returns the trace for chaining."""
    d = trace.arrival_hours.shape[0]
    for name in ("c0", "valid", "lam", "mu", "sig", "obs_window",
                 "spont_death", "n_core_deaths", "core_hours", "n_scaleouts",
                 "scaleout_cores"):
        shape = tuple(getattr(trace, name).shape)
        if shape != (d,):
            raise ValueError(f"trace.{name} has shape {shape}, want ({d},)")
    ev = trace.events
    if not (ev.t_offset.shape == ev.cores.shape == ev.valid.shape):
        raise ValueError("event buffer fields disagree on shape")
    if ev.t_offset.ndim != 2 or ev.t_offset.shape[0] != d:
        raise ValueError(
            f"event buffer leading dim {tuple(ev.t_offset.shape)} != {d}")
    t = host(trace.arrival_hours)
    v = host(trace.valid)
    if v.any():
        tv = t[v]
        if np.any(np.diff(tv) < 0):
            raise ValueError("valid arrival_hours must be sorted")
        if np.any(tv < 0) or np.any(tv > float(host(trace.horizon_hours))):
            raise ValueError("arrival_hours outside [0, horizon_hours]")
    return trace


# ---------------------------------------------------------------------------
# NPZ persistence (lossless)
# ---------------------------------------------------------------------------

_EVENT_PREFIX = "events_"


def save_npz(trace: WorkloadTrace, path: str) -> None:
    """Lossless archive of every column (including the invalid tail)."""
    arrays = {k: host(v) for k, v in trace._asdict().items()
              if k != "events"}
    for k, v in trace.events._asdict().items():
        arrays[_EVENT_PREFIX + k] = host(v)
    np.savez(path, **arrays)


def load_npz(path: str, *, device="cuda") -> WorkloadTrace:
    """Inverse of ``save_npz``, the columns on ``device`` (the card unless
    the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    col = lambda z, k: torch.from_numpy(np.array(z[k])).to(device)
    with np.load(path) as z:
        events = ScaleoutEvents(**{k: col(z, _EVENT_PREFIX + k)
                                   for k in ScaleoutEvents._fields})
        cols = {k: col(z, k) for k in WorkloadTrace._fields if k != "events"}
    return validate_trace(WorkloadTrace(events=events, **cols))


# ---------------------------------------------------------------------------
# CSV persistence (valid rows only; two tables)
# ---------------------------------------------------------------------------

_DEP_COLS = ("arrival_hours", "c0", "lam", "mu", "sig", "obs_window",
             "spont_death", "n_core_deaths", "core_hours", "n_scaleouts",
             "scaleout_cores")


def events_csv_path(path: str) -> str:
    return path + ".events.csv"


def save_csv(trace: WorkloadTrace, path: str) -> None:
    """Two tables: ``path`` (deployments, valid rows) and
    ``path.events.csv`` (long-format event stream keyed by deployment row).
    Compacts the trace — invalid rows/events are dropped."""
    v = host(trace.valid)
    idx = np.nonzero(v)[0]
    cols = {k: host(getattr(trace, k)) for k in _DEP_COLS}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("deployment",) + _DEP_COLS +
                   (f"horizon_hours={float(host(trace.horizon_hours))!r}",))
        for new_i, i in enumerate(idx):
            w.writerow([new_i] + [repr(float(cols[k][i])) for k in _DEP_COLS])
    ev = trace.events
    ev_valid = host(ev.valid)
    ev_t = host(ev.t_offset)
    ev_c = host(ev.cores)
    with open(events_csv_path(path), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("deployment", "t_offset", "cores"))
        for new_i, i in enumerate(idx):
            for j in np.nonzero(ev_valid[i])[0]:
                w.writerow((new_i, repr(float(ev_t[i, j])),
                            repr(float(ev_c[i, j]))))


def load_csv(path: str, max_events: int | None = None, *,
             device="cuda") -> WorkloadTrace:
    """Inverse of ``save_csv``, the columns on ``device``. The event buffer
    width defaults to the largest per-deployment event count found in the
    events table."""
    device = resolve_device(device)
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    horizon = float(header[-1].split("=", 1)[1])
    d = len(rows)
    cols = {k: np.empty(d, np.float64) for k in _DEP_COLS}
    for r, row in enumerate(rows):
        for k, cell in zip(_DEP_COLS, row[1:]):
            cols[k][r] = float(cell)

    ev_by_dep: dict[int, list[tuple[float, float]]] = {}
    ev_path = events_csv_path(path)
    if os.path.exists(ev_path):
        with open(ev_path, newline="") as f:
            for row in list(csv.reader(f))[1:]:
                ev_by_dep.setdefault(int(row[0]), []).append(
                    (float(row[1]), float(row[2])))
    e = max_events if max_events is not None else max(
        [len(v) for v in ev_by_dep.values()], default=1)
    e = max(e, 1)
    ev_t = np.zeros((d, e), np.float32)
    ev_c = np.zeros((d, e), np.float32)
    ev_v = np.zeros((d, e), bool)
    for i, evs in ev_by_dep.items():
        for j, (t, c) in enumerate(evs[:e]):
            ev_t[i, j], ev_c[i, j], ev_v[i, j] = t, c, True

    dev = lambda a: torch.from_numpy(a).to(device)
    f32 = lambda k: dev(cols[k].astype(np.float32))
    return validate_trace(WorkloadTrace(
        arrival_hours=f32("arrival_hours"),
        c0=f32("c0"),
        valid=dev(np.ones(d, bool)),
        lam=f32("lam"), mu=f32("mu"), sig=f32("sig"),
        obs_window=f32("obs_window"),
        spont_death=dev(cols["spont_death"] > 0.5),
        n_core_deaths=f32("n_core_deaths"),
        core_hours=f32("core_hours"),
        n_scaleouts=f32("n_scaleouts"),
        scaleout_cores=f32("scaleout_cores"),
        events=ScaleoutEvents(t_offset=dev(ev_t), cores=dev(ev_c),
                              valid=dev(ev_v)),
        horizon_hours=dev(np.asarray(horizon, np.float32)),
    ))
