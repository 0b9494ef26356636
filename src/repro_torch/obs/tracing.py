"""Decision tracing: structured per-decision records + profiler ranges.

``DecisionTracer`` is the host-side half of the observability layer: the
engine (or any caller) hands it one structured record per admission decision
— step, deployment id, policy kind, threshold, moment-curve score, verdict,
submit→decision latency, batch size. Records are buffered as they come (the
engine hands over numpy values, materialized once per decided chunk) and
written to the JSONL sink when the buffer drains, so tracing costs the
decision path a list append. A tensor value is copied to the host at the
drain.

``annotate(name)`` opens a named ``torch.profiler`` range: the engine's
refresh / tick / flush regions (``repro.engine.*``) and the simulator's
layers (``repro.sim.*``, ``SIM_SPANS``) show by name in a ``torch.profiler``
trace of a step. With no profiler running a range costs one check and
nothing else.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import IO, Optional

import numpy as np
import torch

from .log import get_logger

log = get_logger(__name__)

#: buffered records before an automatic drain
DEFAULT_CAPACITY = 4096

#: the simulator's ranges, each opened once a batch or once a step, never
#: once a run or a candidate; a range's parent is the innermost one that
#: contains it (batch > step > draws, ...):
#:
#:   repro.sim.batch       ``run_keyed_batch``, the call (and each device
#:                         chunk of a split batch)
#:   repro.sim.stream      the run's arrival stream, its per-step views and
#:                         the candidates' rows, before the step loop
#:   repro.sim.init        the fresh state
#:   repro.sim.step        one iteration of the step loop
#:   repro.sim.refresh     the aggregate refresh (the kernel, or zeros)
#:   repro.sim.draws       one step's event draws (``sample_step_events``)
#:   repro.sim.events      deaths, grants, belief updates, the rider's fold
#:   repro.sim.candidates  the candidates' curves (the rows kernel, or zeros)
#:   repro.sim.decide      the policy's sequential admission
#:   repro.sim.place       slot placement and the rider's decision fold
#:   repro.sim.route       a fleet's router (draw, assign)
#:   repro.sim.metrics     the run metrics and the stacked traces and
#:                         decisions, after the loop
SIM_SPANS = ("repro.sim.batch", "repro.sim.stream", "repro.sim.init",
             "repro.sim.step", "repro.sim.refresh", "repro.sim.draws",
             "repro.sim.events", "repro.sim.candidates", "repro.sim.decide",
             "repro.sim.place", "repro.sim.route", "repro.sim.metrics")

_OFF = contextlib.nullcontext()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def _jsonable(value):
    """Convert one drained field to a JSON-serializable python value."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if isinstance(value, (np.ndarray, np.generic)):
        if value.ndim == 0:
            value = value.item()
        else:
            return np.asarray(value).tolist()
    if isinstance(value, float):
        return round(value, 6)
    if isinstance(value, (bool, int, str)) or value is None:
        return value
    return repr(value)


class DecisionTracer:
    """Buffered JSONL sink for per-decision trace records.

    ``record(**fields)`` appends one structured record; field values may be
    python scalars, numpy values or tensors. ``drain()`` writes one JSON
    object per line to the sink. The buffer drains itself at ``capacity``;
    ``close()`` drains and closes a sink the tracer opened (a
    caller-provided file object stays open).

    A tracer is also a context manager: ``with DecisionTracer(path) as tr:``.
    """

    def __init__(self, sink: str | os.PathLike | IO[str],
                 capacity: int = DEFAULT_CAPACITY):
        if hasattr(sink, "write"):
            self._fh: Optional[IO[str]] = sink  # caller-owned
            self._owns = False
        else:
            self._fh = open(os.fspath(sink), "a", encoding="utf-8")
            self._owns = True
        self.capacity = int(capacity)
        self._buf: list[dict] = []
        self.n_recorded = 0
        self.n_written = 0

    def record(self, **fields) -> None:
        """Buffer one decision record."""
        self._buf.append(fields)
        self.n_recorded += 1
        if len(self._buf) >= self.capacity:
            self.drain()

    def drain(self) -> int:
        """Write every buffered record; returns the count."""
        if not self._buf or self._fh is None:
            n, self._buf = len(self._buf), []
            return n
        buf, self._buf = self._buf, []
        for rec in buf:
            line = {k: _jsonable(v) for k, v in rec.items()}
            self._fh.write(json.dumps(line, separators=(",", ":")) + "\n")
        self._fh.flush()
        self.n_written += len(buf)
        return len(buf)

    def close(self) -> None:
        """Drain, then close the sink if this tracer opened it."""
        self.drain()
        if self._owns and self._fh is not None:
            self._fh.close()
            self._fh = None
        log.debug("tracer closed: %d records written", self.n_written)

    def __enter__(self) -> "DecisionTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def annotate(name: str):
    """A named ``torch.profiler`` range while a profiler runs, else one
    shared ``contextlib.nullcontext()``: with no profiler running a range
    costs the check of ``torch.autograd._profiler_enabled()`` alone.

    Wrap admission phases so a captured profiler trace attributes host and
    device time to them::

        with annotate("repro.engine.flush"):
            accept = self._decide(...)

    The range is a host operator of its own (``_RecordFunctionFast``, the
    range ``torch.compile``'s code opens), not a user annotation
    (``record_function``): under CUDA activity the profiler adds a
    device-side copy of a user annotation spanning its kernels and the gaps
    between them, which a reader of the card's activity would count as a
    kernel and as busy time. So the ranges show on the host's timeline of a
    chrome or Perfetto trace and not on the card's. ``_RecordFunctionFast``
    is private to torch (checked on 2.11 and 2.13); where a torch lacks it
    the range is a ``record_function`` instead.
    """
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _RANGE(name)
