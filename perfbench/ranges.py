"""The port's named ranges in the traced stretch, beside the card's kernels.

While a profiler runs, the port opens a host range at each layer boundary
of its simulator (``repro.sim.batch``, ``.stream``, ``.init``, ``.step``,
``.refresh``, ``.draws``, ``.events``, ``.candidates``, ``.decide``,
``.place``, ``.route``, ``.metrics``: ``SIM_SPANS`` in the port's
``obs/tracing.py``). ``trace.profile`` keeps the card's activity and the
host's ``aten::`` operators only, so importing this module wraps
``trace._events``, which ``profile`` calls once on its profiler, to keep
that profiler's whole event list too. ``of(trace)`` reads it, all on the
profiler's one clock (us):

  * ``spans``: the host's ranges, ``(name, start, dur)``, sorted by start;
  * ``device`` and ``kernels``: as ``trace.profile`` has them, with user
    annotations (a range's device-side copy) left out;
  * ``launch_us``: each kernel's launch on the host, by its index in
    ``kernels``: the runtime call (``cudaLaunchKernel``, ``...ExC`` of the
    ctypes launchers, ``cuLaunchKernel``) with the kernel's correlation id.

The helpers: ``self_us`` (a range's time less its child ranges), the
kernels launched inside a range, ``idle_by_span`` (each idle gap between
device intervals put down to the innermost range open over most of it),
and ``table``, the span table the traced run prints on standard error.
Nothing to read (``None``) where the trace holds none of the card's
activity.
"""
from __future__ import annotations

import bisect
import sys
from typing import NamedTuple

import torch

from perfbench import trace as _trace

_COPIES = ("Memcpy", "Memset")
STEP, BATCH = "repro.sim.step", "repro.sim.batch"
OUTSIDE = "(outside the ranges)"
_KEPT: dict = {}


class Ranges(NamedTuple):
    steps: int          # batched steps the stretch ran
    window_us: float    # its wall time, host clock
    spans: list         # (name, start, dur) of the host's ranges, by start
    parent: list        # each span's innermost enclosing span, or -1
    device: list        # (name, start, dur): kernels, copies and sets
    kernels: list       # (name, start, dur): kernels only
    launch_us: dict     # kernel index -> its launch's start on the host
    dropped: int        # user annotations on the device, left out


def _kineto(prof):
    """(name, is_device, start_us, dur_us, is_user_annotation,
    correlation id) of every event of a finished profiler."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name(), e.device_type() != cpu, e.start_ns() / 1e3,
             e.duration_ns() / 1e3, e.is_user_annotation(),
             e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _keeping(events_fn):
    def events(prof):
        out = events_fn(prof)
        _KEPT.clear()
        try:
            _KEPT["events"] = _kineto(prof)
        except AttributeError:
            pass
        return out

    events.keeps = True
    return events


if not getattr(_trace._events, "keeps", False):
    _trace._events = _keeping(_trace._events)


def build(events, steps: int, window_s: float) -> Ranges:
    """``Ranges`` of a list of ``_kineto`` tuples."""
    spans, device, corr, launches, dropped = [], [], [], {}, 0
    for name, dev, start, dur, annotation, cid in events:
        if dev:
            if annotation:
                dropped += 1
            else:
                device.append((name, start, dur))
                corr.append(cid)
        elif annotation or name.startswith("repro."):
            spans.append((name, start, dur))
        elif name.startswith("cu"):     # a runtime or driver call
            launches[cid] = start
    kernels, launch_us = [], {}
    for e, cid in zip(device, corr):
        if not e[0].startswith(_COPIES):
            if cid in launches:
                launch_us[len(kernels)] = launches[cid]
            kernels.append(e)
    spans.sort(key=lambda e: (e[1], -e[2]))
    return Ranges(steps=steps, window_us=window_s * 1e6, spans=spans,
                  parent=_nest(spans), device=device, kernels=kernels,
                  launch_us=launch_us, dropped=dropped)


def of(trace):
    """The ``Ranges`` of the traced stretch ``trace`` (a ``trace.Trace``),
    read once; ``None`` without the card's activity, or where the kept
    events are not that stretch's. The first read prints ``table``."""
    if trace is None or not trace.device or "events" not in _KEPT:
        return None
    if _KEPT.get("trace") is not trace:
        rg = build(_KEPT["events"], trace.steps, trace.window_s)
        # trace.profile counts the card's user annotations as device events
        if len(rg.device) + rg.dropped != len(trace.device):
            return None
        _KEPT.update(trace=trace, ranges=rg)
        print(table(rg), file=sys.stderr, flush=True)
    return _KEPT["ranges"]


def _nest(spans) -> list:
    """Each span's parent, the innermost span that contains it (spans
    sorted by start, the longer first), or -1."""
    parent, stack = [], []
    for _, s, d in spans:
        while stack and spans[stack[-1]][1] + spans[stack[-1]][2] < s + d:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def self_us(rg: Ranges) -> list:
    """Each span's duration less the part its child spans cover."""
    own = [d for _, _, d in rg.spans]
    for i, p in enumerate(rg.parent):
        if p >= 0:
            own[p] -= rg.spans[i][2]
    return own


def segments(rg: Ranges) -> list:
    """(start, end, span index) of the stretches of host time in which
    each span is the innermost one open, sorted by start."""
    children = [[] for _ in rg.spans]
    for i, p in enumerate(rg.parent):
        if p >= 0:
            children[p].append(i)
    out = []
    for i, (_, s, d) in enumerate(rg.spans):
        t = s
        for c in children[i]:
            out.append((t, rg.spans[c][1], i))
            t = rg.spans[c][1] + rg.spans[c][2]
        out.append((t, s + d, i))
    return sorted(e for e in out if e[1] > e[0])


def innermost(segs, t: float) -> int:
    """The span innermost at host time ``t`` (``segments``), or -1."""
    k = bisect.bisect_right(segs, (t, float("inf"), 0)) - 1
    return segs[k][2] if k >= 0 and t <= segs[k][1] else -1


def calls(rg: Ranges, name: str) -> int:
    """How many spans named ``name`` the stretch opened."""
    return sum(1 for n, _, _ in rg.spans if n == name)


def launched_in(rg: Ranges, name: str) -> list:
    """Indices of the kernels launched inside a span named ``name``."""
    iv = _trace.intervals([e for e in rg.spans if e[0] == name])
    starts = [s for s, _ in iv]
    out = []
    for i, t in rg.launch_us.items():
        k = bisect.bisect_right(starts, t) - 1
        if k >= 0 and t <= iv[k][1]:
            out.append(i)
    return out


def device_ms_in(rg: Ranges, name: str) -> float:
    """Device ms of the kernels launched inside spans named ``name``."""
    return sum(rg.kernels[i][2] for i in launched_in(rg, name)) / 1e3


def host_ms(rg: Ranges, name: str) -> float:
    """Host ms inside spans named ``name`` (a nested one counted once)."""
    iv = _trace.intervals([e for e in rg.spans if e[0] == name])
    return sum(e - s for s, e in iv) / 1e3


def idle_by_span(rg: Ranges) -> dict:
    """{span name: idle us} over the traced stretch: each gap between
    device intervals goes whole to the innermost span open on the host
    over most of it, or to ``OUTSIDE`` where no span is; ``OUTSIDE`` also
    takes the idle time before the first and after the last device
    interval. The values add up to the stretch's wall less its busy
    time."""
    iv = _trace.intervals(rg.device)
    segs = segments(rg)
    starts = [s for s, _, _ in segs]
    out = {OUTSIDE: 0.0}
    gaps = 0.0
    for (_, g0), (g1, _) in zip(iv, iv[1:]):
        over = {}
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        while k < len(segs) and segs[k][0] < g1:
            ov = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if ov > 0:
                over[segs[k][2]] = over.get(segs[k][2], 0.0) + ov
            k += 1
        best = max(over, key=over.get, default=-1)
        if best >= 0 and over[best] < (g1 - g0) - sum(over.values()):
            best = -1
        name = rg.spans[best][0] if best >= 0 else OUTSIDE
        out[name] = out.get(name, 0.0) + (g1 - g0)
        gaps += g1 - g0
    busy = sum(e - s for s, e in iv)
    out[OUTSIDE] += rg.window_us - busy - gaps
    return out


def rows(rg: Ranges) -> list:
    """The span table's rows: (range, calls, host self us, kernels,
    device us, idle us), one a range name in order of first opening, the
    step's own residue (``repro.sim.step``'s self time) last, then the
    host time, launches and idle outside every range."""
    own = self_us(rg)
    segs = segments(rg)
    row = {}
    for i, (name, _, _) in enumerate(rg.spans):
        r = row.setdefault(name, [0, 0.0, 0, 0.0, 0.0])
        r[0] += 1
        r[1] += own[i]
    outside = [0, 0.0, 0, 0.0, 0.0]
    for i, t in rg.launch_us.items():
        j = innermost(segs, t)
        r = row[rg.spans[j][0]] if j >= 0 else outside
        r[2] += 1
        r[3] += rg.kernels[i][2]
    idle = idle_by_span(rg)
    for name, us in idle.items():
        (row[name] if name in row else outside)[4] += us
    top = [d for (_, _, d), p in zip(rg.spans, rg.parent) if p < 0]
    outside[1] = rg.window_us - sum(top)
    names = [n for n in row if n != STEP] + ([STEP] if STEP in row else [])
    out = [(n if n != STEP else STEP + " (residue)", *row[n])
           for n in names]
    return out + [(OUTSIDE, *outside)]


def table(rg: Ranges) -> str:
    """The span table, per batched step, with its two sums: the ranges'
    self times (the step's residue among them) against the batch range's
    host time, and the idle column against the stretch's idle share."""
    n = rg.steps
    lines = [f"perfbench: ranges over {n} traced steps (per step; idle "
             "share of the stretch's wall)",
             f"{'range':34s} {'calls':>6s} {'host self ms':>12s} "
             f"{'kernels':>9s} {'device ms':>9s} {'idle ms':>8s} "
             f"{'idle share':>10s}"]
    body = rows(rg)
    for name, n_calls, own, k, dev, idle in body:
        lines.append(f"{name:34s} {n_calls:6d} {own / 1e3 / n:12.4f} "
                     f"{k / n:9.2f} {dev / 1e3 / n:9.4f} "
                     f"{idle / 1e3 / n:8.4f} {idle / rg.window_us:10.5f}")
    inside = sum(r[2] for r in body[:-1])
    idle = sum(r[5] for r in body)
    lines.append(
        f"perfbench: ranges' self times {inside / 1e3 / n:.4f} ms a step, "
        f"{BATCH} {host_ms(rg, BATCH) / n:.4f}; idle column "
        f"{idle / rg.window_us:.6f} of the wall, idle_share "
        f"{1.0 - _trace.busy_us(rg) / rg.window_us:.6f}; "
        f"{len(rg.kernels) - len(rg.launch_us)} kernels without a launch, "
        f"{rg.dropped} user annotations on the device left out")
    return "\n".join(lines)
