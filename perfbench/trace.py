"""The traced stretch: ``torch.profiler`` over one call, read in memory.

``profile(fn)`` runs ``fn`` under the profiler (host operators and the
card's activity), waits for the card, and returns a ``Trace`` of plain
tuples: the device's kernels and copies, and the host's ``aten::``
operators, each ``(name, start_us, duration_us)`` on the profiler's common
clock. No trace file is written. ``busy_us`` is the union of the device
intervals; ``idle_gaps`` names each gap between them by the host operator
that overlaps it most.
"""
from __future__ import annotations

import bisect
import time
import warnings
from typing import NamedTuple

import torch

_COPIES = ("Memcpy", "Memset")


class Trace(NamedTuple):
    steps: int                 # batched steps the stretch ran
    window_s: float            # its wall time, host clock
    kernels: list              # (name, start_us, dur_us), kernels only
    device: list               # kernels, copies and sets
    host_ops: list             # aten:: operators on the host


def _events(prof):
    """(name, is_device, start_us, dur_us) of every event."""
    try:
        evs = prof.profiler.kineto_results.events()
        out = []
        for e in evs:
            dev = e.device_type() != torch.autograd.DeviceType.CPU
            out.append((e.name(), dev, e.start_ns() / 1e3,
                        e.duration_ns() / 1e3))
        return out
    except AttributeError:
        return [(e.name, e.device_type != torch.autograd.DeviceType.CPU,
                 e.time_range.start, e.time_range.elapsed_us())
                for e in prof.events()]


def profile(fn, steps: int, sync) -> Trace:
    """``fn()`` under the profiler; ``sync()`` waits for the device."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with warnings.catch_warnings():
        # a profile without a schedule is one cycle: nothing is cleared
        warnings.filterwarnings("ignore", "Profiler clears events")
        prof = torch.profiler.profile(activities=acts)
    with prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    device, host = [], []
    for name, dev, start, dur in _events(prof):
        if dev:
            device.append((name, start, dur))
        elif name.startswith("aten::"):
            host.append((name, start, dur))
    kernels = [e for e in device if not e[0].startswith(_COPIES)]
    return Trace(steps=steps, window_s=wall, kernels=kernels, device=device,
                 host_ops=host)


def intervals(events) -> list:
    """The union of ``events``' intervals, sorted: [(start, end)]."""
    out = []
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return [tuple(x) for x in out]


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in intervals(trace.device))


def top_device_ops(trace: Trace, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time."""
    tot = {}
    for name, _, d in trace.device:
        tot[name] = tot.get(name, 0.0) + d
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], d / 1e6] for name, d in top]


def idle_gaps(trace: Trace, n: int = 10) -> list:
    """[[host operator, seconds]] of the longest idle gaps between device
    intervals, each named by the host operator overlapping it most."""
    iv = intervals(trace.device)
    gaps = sorted(((iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)),
                  key=lambda g: g[0] - g[1])[:n]
    ops = sorted(trace.host_ops, key=lambda e: e[1])
    starts = [e[1] for e in ops]
    longest = max((d for _, _, d in ops), default=0.0)
    out = []
    for g0, g1 in gaps:
        best, name = 0.0, "idle"
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        for op, s, d in ops[lo:hi]:
            ov = min(g1, s + d) - max(g0, s)
            if ov > best:
                best, name = ov, op
        out.append([name, (g1 - g0) / 1e6])
    return out
