"""Decision tracing: structured per-decision records + profiler ranges.

``DecisionTracer`` is the host-side half of the observability layer: the
engine (or any caller) hands it one structured record per admission decision
— step, deployment id, policy kind, threshold, moment-curve score, verdict,
submit→decision latency, batch size. Records are buffered as they come (the
engine hands over numpy values, materialized once per decided chunk) and
written to the JSONL sink when the buffer drains, so tracing costs the
decision path a list append. A tensor value is copied to the host at the
drain.

``annotate(name)`` is ``torch.profiler.record_function``, so the engine's
refresh / tick / flush regions show as named ranges in a ``torch.profiler``
trace of the step.
"""
from __future__ import annotations

import json
import os
from typing import IO, Optional

import numpy as np
import torch

from .log import get_logger

log = get_logger(__name__)

#: buffered records before an automatic drain
DEFAULT_CAPACITY = 4096


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
    """A named ``torch.profiler`` range (``record_function``).

    Wrap engine step / aggregate-refresh / flush regions so a captured
    profiler trace attributes host and device time to admission phases::

        with annotate("repro.engine.flush"):
            accept = self._decide(...)
    """
    return torch.profiler.record_function(name)
