"""The simulator's named profiler ranges (``obs.tracing.SIM_SPANS``), on
the CPU.

* Under ``torch.profiler`` a small ``make_run`` batch opens each
  ``repro.sim.*`` range the expected number of times (the batch's once,
  the step's T times, the refresh's T / K times), each inside the range
  the module docs name as its parent; the counts do not grow with the
  batch's runs, and a fleet run also opens ``repro.sim.route``.
* The runs' metrics and decisions are bit for bit the same with a
  profiler on or off.
* The ranges are host operators of their own, not user annotations, so
  the profiler makes no device-side copy of them.
* Outside a profiler ``annotate`` returns one shared null context.
"""
import contextlib
import math
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import SECOND, ZEROTH, fleet_policy, make_policy
from repro_torch.obs import SIM_SPANS, annotate
from repro_torch.sim import (make_config, make_fleet_config, make_fleet_run,
                             make_run, run_keyed_batch)

T, K = 6, 3
CFG = dict(arrival_rate=0.5, horizon_hours=T * 24.0, dt=24.0, max_slots=64,
           max_arrivals=4, d_points=8, agg_refresh_steps=K)
GRID = np.exp(np.linspace(np.log(24.0), np.log(2_000.0), 12)
              ).astype(np.float32)
CAPS = (300.0, 200.0)
PARENT = {"repro.sim.stream": "repro.sim.batch",
          "repro.sim.init": "repro.sim.batch",
          "repro.sim.step": "repro.sim.batch",
          "repro.sim.metrics": "repro.sim.batch",
          "repro.sim.refresh": "repro.sim.step",
          "repro.sim.draws": "repro.sim.step",
          "repro.sim.events": "repro.sim.step",
          "repro.sim.candidates": "repro.sim.step",
          "repro.sim.decide": "repro.sim.step",
          "repro.sim.place": "repro.sim.step",
          "repro.sim.route": "repro.sim.step"}


def _single(kind, runs):
    run = make_run(make_config(capacity=500.0, **CFG), GRID, kind,
                   record_decisions=True, device="cpu")
    theta = dict(rho=0.1) if kind == SECOND else dict(threshold=300.0)
    policy = make_policy(kind, capacity=500.0, device="cpu", **theta)
    return lambda: run_keyed_batch(run, list(range(7, 7 + runs)), policy)


def _fleet(runs):
    fcfg = make_fleet_config(CAPS, **CFG)
    run = make_fleet_run(fcfg, GRID, SECOND, record_decisions=True,
                         device="cpu")
    policy = fleet_policy(SECOND, capacities=CAPS, device="cpu", rho=0.1)
    return lambda: run_keyed_batch(run, list(range(7, 7 + runs)), policy)


def _profiled(fn):
    """(fn's output, [(name, start, end, is_user_annotation)] of the
    ``repro.`` ranges it opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.is_user_annotation())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("repro.")]
    return out, spans


def _parents(spans):
    """Each span's innermost enclosing span's name (or None)."""
    out = []
    for name, s, e, _ in spans:
        around = [(e2 - s2, n2) for n2, s2, e2, _ in spans
                  if s2 <= s and e <= e2 and (s2, e2) != (s, e)]
        out.append((name, min(around)[1] if around else None))
    return out


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for sub in tree for x in _flat(sub)]


def _counts(fleet):
    want = {"repro.sim.batch": 1, "repro.sim.stream": 1,
            "repro.sim.init": 1, "repro.sim.metrics": 1,
            "repro.sim.refresh": math.ceil(T / K)}
    for name in ("step", "draws", "events", "candidates", "decide",
                 "place") + (("route",) if fleet else ()):
        want[f"repro.sim.{name}"] = T
    return want


@pytest.mark.parametrize("kind", [SECOND, ZEROTH], ids=["SECOND", "ZEROTH"])
def test_a_batch_opens_each_range_per_batch_and_per_step(kind):
    for runs in (2, 3):
        _, spans = _profiled(_single(kind, runs))
        assert Counter(n for n, *_ in spans) == _counts(fleet=False)
        for name, parent in _parents(spans):
            assert parent == PARENT.get(name), name


def test_a_fleet_batch_also_opens_the_router_range():
    _, spans = _profiled(_fleet(2))
    assert Counter(n for n, *_ in spans) == _counts(fleet=True)
    assert {n for n, *_ in spans} == set(SIM_SPANS)
    for name, parent in _parents(spans):
        assert parent == PARENT.get(name), name


@pytest.mark.parametrize("make", [lambda: _single(SECOND, 3),
                                  lambda: _single(ZEROTH, 3),
                                  lambda: _fleet(2)],
                         ids=["SECOND", "ZEROTH", "fleet"])
def test_outputs_bit_for_bit_with_the_profiler_on_or_off(make):
    fn = make()
    off = _flat(fn())
    on, _ = _profiled(fn)
    on = _flat(on)
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_ranges_are_not_user_annotations():
    _, spans = _profiled(_single(SECOND, 2))
    assert spans and not any(ua for *_, ua in spans)


def test_annotate_outside_a_profiler_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = annotate("repro.sim.step")
    assert isinstance(off, contextlib.nullcontext)
    assert annotate("repro.sim.draws") is off
    with off, off:      # reusable and reentrant
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = annotate("repro.sim.step")
        assert not isinstance(on, contextlib.nullcontext)
        with on:
            torch.ones(2).sum()
