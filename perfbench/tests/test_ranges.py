"""The reading of the port's ranges (``perfbench/ranges.py``) and the five
metrics on it, on the CPU.

A small synthetic profile, computed by hand: two steps of a batch, its
kernels with their launches on the host (by correlation id), a copy, a
kernel with no launch found, and host operators whose ids collide with
the kernels'. Its user annotations, a range's device-side copy and a
host-side one, leave the device's events as they are. A tiny traced run
on the CPU keeps the port's ranges, and the five metrics report nothing
there: the trace holds none of the card's activity.
"""
from types import SimpleNamespace

import pytest

from perfbench import harness, ranges, trace
from perfbench.tests.tiny import run_tiny

NEW = ("draws_ms_per_step", "policy_ms_per_step", "refresh_device_ms",
       "driver_ms_per_step", "draws_idle_share")
STEPS, WINDOW_US = 2, 110.0


def _host(name, start, end, cid=0):
    return (name, False, start, end - start, False, cid)


def _kernel(name, start, end, cid):
    return (name, True, start, end - start, False, cid)


# host ranges (us): batch [0, 100] > stream [2, 10], step [20, 51] >
# (refresh [21, 24], draws [24, 30], decide [34, 45]), step [55, 85] >
# draws [57, 70], metrics [90, 98]
EVENTS = [
    _host("repro.sim.batch", 0, 100), _host("repro.sim.stream", 2, 10),
    _host("aten::add", 2.5, 3.5, 7),           # its id is k0's: no launch
    _host("cudaLaunchKernel", 3, 3.5, 7),
    _kernel("fill", 5, 6, 7),
    _host("repro.sim.step", 20, 51), _host("repro.sim.refresh", 21, 24),
    _host("cudaLaunchKernelExC", 22, 22.5, 8),
    _kernel("agg_kernel", 23, 26, 8),
    _host("repro.sim.draws", 24, 30),
    _host("cudaLaunchKernel", 25, 25.5, 9),
    _kernel("binomial", 26, 28, 9),
    _host("repro.sim.decide", 34, 45),
    _host("cudaLaunchKernel", 37, 37.5, 10),
    _kernel("admit", 40, 41, 10),
    _host("repro.sim.step", 55, 85), _host("repro.sim.draws", 57, 70),
    _host("cudaLaunchKernel", 58, 58.5, 11),
    _kernel("poisson", 60, 64, 11),
    _host("cudaMemcpyAsync", 66, 66.5, 12),
    _kernel("Memcpy DtoH", 70, 72, 12),
    _host("repro.sim.metrics", 90, 98),
    _host("cudaLaunchKernel", 91, 91.5, 13),
    _kernel("sum", 95, 96, 13),
    _kernel("orphan", 97, 97.5, 14),           # no launch in the profile
]
# a range's device-side copy over its kernels, and a host-side one
ANNOTATIONS = [("repro.sim.batch", True, 5, 92.5, True, 1),
               ("user.range", False, 200, 1, True, 2)]


def _trace_of(events):
    """The ``trace.Trace`` that ``trace.profile`` makes of ``events``."""
    device = [(n, s, d) for n, dev, s, d, _, _ in events if dev]
    return trace.Trace(steps=STEPS, window_s=WINDOW_US / 1e6,
                       kernels=[e for e in device
                                if not e[0].startswith("Memcpy")],
                       device=device,
                       host_ops=[(n, s, d) for n, dev, s, d, _, _ in events
                                 if not dev and n.startswith("aten::")])


def _rg():
    return ranges.build(EVENTS, STEPS, WINDOW_US / 1e6)


def test_user_annotations_leave_the_device_events_as_they_are():
    plain = _rg()
    both = ranges.build(EVENTS + ANNOTATIONS, STEPS, WINDOW_US / 1e6)
    assert both.device == plain.device == _trace_of(EVENTS).device
    assert both.kernels == plain.kernels == _trace_of(EVENTS).kernels
    assert both.launch_us == plain.launch_us
    assert (both.dropped, plain.dropped) == (1, 0)
    assert [s for s in both.spans if s not in plain.spans] == [
        ("user.range", 200, 1)]


def test_launches_found_by_correlation_id():
    rg = _rg()
    names = [k[0] for k in rg.kernels]
    assert "Memcpy DtoH" not in names
    assert {names[i]: t for i, t in rg.launch_us.items()} == {
        "fill": 3, "agg_kernel": 22, "binomial": 25, "admit": 37,
        "poisson": 58, "sum": 91}
    got = lambda n: sorted(names[i] for i in ranges.launched_in(rg, n))
    assert got("repro.sim.draws") == ["binomial", "poisson"]
    assert got("repro.sim.refresh") == ["agg_kernel"]
    assert len(got("repro.sim.batch")) == 6
    assert ranges.device_ms_in(rg, "repro.sim.draws") == pytest.approx(6e-3)


def test_self_times_by_hand():
    rg = _rg()
    own = dict.fromkeys((n for n, _, _ in rg.spans), 0.0)
    for (name, _, _), us in zip(rg.spans, ranges.self_us(rg)):
        own[name] += us
    assert own == {"repro.sim.batch": 23, "repro.sim.stream": 8,
                   "repro.sim.step": 11 + 17, "repro.sim.refresh": 3,
                   "repro.sim.draws": 19, "repro.sim.decide": 11,
                   "repro.sim.metrics": 8}
    assert sum(own.values()) == 100     # the batch range's host time


def test_idle_gaps_by_span_by_hand():
    rg = _rg()
    idle = ranges.idle_by_span(rg)
    # gaps [6, 23] batch, [28, 40] decide, [41, 60] and [72, 95] the
    # steps, [64, 70] draws, [96, 97] metrics; 17.5 us at the edges
    assert idle == pytest.approx({
        "repro.sim.batch": 17, "repro.sim.decide": 12, "repro.sim.step": 42,
        "repro.sim.draws": 6, "repro.sim.metrics": 1, ranges.OUTSIDE: 17.5})
    busy = trace.busy_us(_trace_of(EVENTS))
    assert busy == 14.5
    ctx = SimpleNamespace(trace=_trace_of(EVENTS))
    idle_share = harness.reader("idle_share").read(ctx)
    assert sum(idle.values()) / WINDOW_US == pytest.approx(idle_share,
                                                           abs=1e-12)


def test_the_table_adds_up():
    rg = _rg()
    body = ranges.rows(rg)
    assert [r[0] for r in body] == [
        "repro.sim.batch", "repro.sim.stream", "repro.sim.refresh",
        "repro.sim.draws", "repro.sim.decide", "repro.sim.metrics",
        "repro.sim.step (residue)", ranges.OUTSIDE]
    by = {r[0]: r[1:] for r in body}
    assert by["repro.sim.step (residue)"] == (2, 28, 0, 0.0, 42)
    assert by["repro.sim.draws"] == (2, 19, 2, 6.0, 6)
    assert by[ranges.OUTSIDE] == (0, 10.0, 0, 0.0, 17.5)
    assert sum(r[2] for r in body[:-1]) == ranges.host_ms(
        rg, "repro.sim.batch") * 1e3
    assert sum(r[5] for r in body) == pytest.approx(WINDOW_US - 14.5)
    assert "1 kernels without a launch" in ranges.table(rg)


def test_the_five_readers_by_hand(monkeypatch):
    monkeypatch.setattr(ranges, "_KEPT", {"events": EVENTS})
    ctx = SimpleNamespace(trace=_trace_of(EVENTS))
    got = {m: harness.reader(m).read(ctx) for m in NEW}
    assert got == pytest.approx({
        "draws_ms_per_step": 19e-3 / 2, "policy_ms_per_step": 11e-3 / 2,
        "refresh_device_ms": 3e-3, "driver_ms_per_step": 39e-3 / 2,
        "draws_idle_share": 6 / WINDOW_US})
    # the card's user annotations, which trace.profile keeps as device
    # events, change no reading
    monkeypatch.setattr(ranges, "_KEPT", {"events": EVENTS + ANNOTATIONS})
    annotated = SimpleNamespace(trace=_trace_of(EVENTS + ANNOTATIONS))
    assert {m: harness.reader(m).read(annotated) for m in NEW} == got
    # the kept events of another stretch are not read
    other = ctx.trace._replace(device=ctx.trace.device[:-1])
    assert harness.reader("draws_ms_per_step").read(
        SimpleNamespace(trace=other)) is None


def test_a_tiny_traced_run_keeps_the_ports_ranges():
    res = run_tiny("paper_full.second.r240", trace=True)
    # a CPU trace holds no device activity: the five report nothing
    assert not set(NEW) & set(res["metrics"])
    rg = ranges.build(ranges._KEPT["events"], 24, 1.0)
    calls = {n: ranges.calls(rg, f"repro.sim.{n}")
             for n in ("batch", "step", "refresh", "draws")}
    assert calls == {"batch": 1, "step": 24, "refresh": 2, "draws": 24}
    for name in ("repro.sim.draws", "repro.sim.decide", "repro.sim.batch"):
        assert ranges.host_ms(rg, name) > 0
    assert (ranges.host_ms(rg, "repro.sim.batch")
            > ranges.host_ms(rg, "repro.sim.step"))
    assert sum(ranges.self_us(rg)) == pytest.approx(
        ranges.host_ms(rg, "repro.sim.batch") * 1e3)
