"""The port's online admission engine against the JAX package's, and against
the port's own ``make_run``.

* Against the JAX engine: both engines ingest the same observed events
  (``tick(events=...)``) and decide the same arrival tickets, through
  ``decide_slice``, through ``submit``/``flush`` and on the naive lane. The
  events and tickets are the JAX package's own draws for the golden
  configuration (seed 1, SECOND rho 0.05, K = 3; ``tests/torch_lockstep.py``
  records them), whose decision margins are all at least 1e-4
  (``test_torch_sim.py``). Accept masks must be equal, the metrics' counts
  equal and their float32 sums within rtol 1e-5 (``test_torch_sim.py``'s
  tolerance), and the telemetry summaries equal.
* Online equals offline in the port, bit for bit: an engine driven by
  ``make_run``'s generator and arrival stream takes ``make_run``'s decisions
  and gives its ``RunMetrics`` and telemetry rider, at ``CFG`` and at
  ``SMALL``, with the rider off and on.
* The port's counterparts of ``tests/test_online_admission.py``: the
  submit/flush front-end, the background pump, observed-event ingestion,
  protocol errors, operating points, window-close idempotence, failing
  flushes, the deadline scheduler, a ticker/pump/submitter stress test, and
  the options' refusals (``shards=`` without the devices, ``drift`` without
  the rider). The fleet mode is tested in
  ``tests/test_torch_fleet_engine.py``, the sharded engine in
  ``tests/test_torch_mesh.py``.
"""
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, ZEROTH, geometric_grid
from repro.core import make_policy as j_make_policy
from repro.serve import Arrival as JArrival
from repro.serve import ExternalEvents as JExternalEvents
from repro.serve import OnlineAdmissionEngine as JEngine
from repro.serve import load_operating_point as j_load_operating_point
from repro.sim import SimConfig
from repro_torch import bridge
from repro_torch.core import make_policy
from repro_torch.obs import DecisionTracer, telemetry_summary
from repro_torch.serve import (Arrival, ExternalEvents, OnlineAdmissionEngine,
                               default_policy_param,
                               format_operating_derived, load_operating_point,
                               operating_row_name, window_seed)
from repro_torch.sim import draw_arrival_stream, make_run
from repro_torch.sim.simulator import _steps
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

# tests/test_online_admission.py's configurations
CFG = SimConfig(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
                dt=24.0, max_slots=96, max_arrivals=4, d_points=8,
                priors=AZURE_PRIORS, agg_refresh_steps=3)
GRID = geometric_grid(24.0, 3 * 30 * 24.0, 12)
SMALL = CFG._replace(horizon_hours=6 * 24.0, max_slots=32,
                     agg_refresh_steps=1)
PCFG, PSMALL = port_config(CFG), port_config(SMALL)
PGRID = np.asarray(GRID)
RHO = 0.05
RTOL_METRICS = 1e-5
COUNTS = ("total_requests", "failed_requests", "arrivals_accepted",
          "arrivals_rejected", "slot_overflow", "n_departed", "alive_end",
          "fail_trace")
TIMEOUT = 60.0


def _policy(cfg, kind=SECOND):
    if kind == ZEROTH:
        return make_policy(ZEROTH, threshold=cfg.capacity,
                           capacity=cfg.capacity)
    return make_policy(SECOND, rho=RHO, capacity=cfg.capacity)


def _engine(cfg, kind=SECOND, **kw):
    return OnlineAdmissionEngine(cfg, PGRID, kind, _policy(cfg, kind),
                                 device="cpu", **kw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# against the JAX engine, on the same events and tickets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_draws():
    """The JAX package's stream (numpy [T, A] leaves) and per-step events
    (numpy [S] leaves) of the golden SECOND run (seed 1, K = 3)."""
    stream, events = reference_draws(CFG, GRID, SECOND,
                                     [jax.random.PRNGKey(1)], [RHO])
    stream = type(stream)(*(type(x)(*(y[0] for y in x))
                            if isinstance(x, tuple) else x[0]
                            for x in stream))
    return stream, [type(ev)(*(x[0] for x in ev)) for ev in events]


def _drive_both(path, stream, events, telemetry=True):
    """Drive a JAX engine and a port engine on the same events and tickets;
    returns (accepts, metrics, snapshot) of each."""
    cfg = CFG._replace(telemetry=telemetry)
    naive = path == "naive"
    j_eng = JEngine(cfg, GRID, SECOND,
                    j_make_policy(SECOND, rho=RHO, capacity=cfg.capacity),
                    naive=naive)
    t_eng = OnlineAdmissionEngine(port_config(cfg), PGRID, SECOND,
                                  _policy(cfg), naive=naive, device="cpu")
    t_stream = bridge.from_reference(stream)
    n_lanes = cfg.max_arrivals
    out = {}
    for name, eng, arrival, ext in (("jax", j_eng, JArrival, JExternalEvents),
                                    ("port", t_eng, Arrival, ExternalEvents)):
        accepts = []
        for t, ev in enumerate(events):
            eng.tick(events=ext(core_deaths=ev.core_deaths,
                                spont_death=ev.spont_death,
                                scaleout_cores=ev.scaleout_cores,
                                n_scaleouts=ev.n_scaleouts))
            n = int(stream.n_arrivals[t])
            valid = np.arange(n_lanes) < n
            if path == "decide_slice":
                if name == "jax":
                    slice_t = jax.tree.map(lambda x: x[t], stream)
                else:
                    slice_t = _steps(t_stream)[t]
                accepts.append(np.asarray(eng.decide_slice(slice_t, valid)))
                continue
            futs = [eng.submit(arrival.from_stream(stream, t, a))
                    for a in range(n)]
            eng.flush()
            row = np.zeros(n_lanes, bool)
            row[:n] = [f.result(timeout=TIMEOUT) for f in futs]
            accepts.append(row)
        out[name] = (np.stack(accepts), eng.metrics(),
                     eng.metrics_snapshot())
    return out


@pytest.mark.parametrize("path", ["decide_slice", "submit", "naive"])
def test_engine_matches_jax_engine(jax_draws, path):
    stream, events = jax_draws
    out = _drive_both(path, stream, events)
    (j_acc, j_m, j_snap), (t_acc, t_m, t_snap) = out["jax"], out["port"]
    np.testing.assert_array_equal(t_acc, j_acc)
    valid = np.arange(CFG.max_arrivals)[None] < np.asarray(
        stream.n_arrivals)[:, None]
    assert j_acc.any() and (valid & ~j_acc).any()
    for name in j_m._fields:
        got, want = getattr(t_m, name).numpy(), np.asarray(getattr(j_m, name))
        if name in COUNTS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL_METRICS,
                                       err_msg=name)
    assert t_snap["telemetry"] == j_snap["telemetry"]
    for key in ("n_requests", "n_flushes", "n_refreshes", "n_ticks",
                "queue_depth", "deadline_misses", "flush_slo_ms",
                "n_shards"):
        assert t_snap["engine"][key] == j_snap["engine"][key], key


# ---------------------------------------------------------------------------
# online equals offline in the port, bit for bit
# ---------------------------------------------------------------------------

def _drive(engine, stream, gen, n_steps):
    """Tick ``engine`` with ``make_run``'s generator and decide each step's
    slice of its stream."""
    n_arr = stream.n_arrivals.numpy()
    lanes = np.arange(stream.c0.shape[1])
    accepts = []
    for t, slice_t in enumerate(_steps(stream)[:n_steps]):
        engine.tick(gen=gen)
        accepts.append(engine.decide_slice(slice_t, lanes < n_arr[t]))
    return np.stack(accepts)


def _assert_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            _assert_equal(x, y)
        else:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("cfg", [PCFG, PSMALL], ids=["CFG", "SMALL"])
def test_online_equals_offline_bit_for_bit(cfg, telemetry):
    cfg = cfg._replace(telemetry=telemetry)
    policy = _policy(cfg)
    want = make_run(cfg, PGRID, SECOND, record_decisions=True,
                    device="cpu")(1, policy)
    gen = _gen(1)
    stream = draw_arrival_stream(gen, cfg)
    eng = OnlineAdmissionEngine(cfg, PGRID, SECOND, policy, device="cpu")
    accept = _drive(eng, stream, gen, cfg.n_steps)
    np.testing.assert_array_equal(accept, want[1].numpy())
    assert accept.any() and not accept.all()
    _assert_equal(eng.metrics(), want[0])
    if telemetry:
        _assert_equal(eng._cs.tel, want[2])
        s = eng.metrics_snapshot()["telemetry"]
        assert s == telemetry_summary(want[2])
        assert s["n_admit"] + s["n_reject_capacity"] + s[
            "n_reject_policy"] == s["n_routed"] == eng.decisions
        assert s["n_windows"] == cfg.n_steps
        assert s["n_refreshes"] == cfg.n_steps // cfg.agg_refresh_steps
    else:
        off = make_run(cfg._replace(telemetry=True), PGRID, SECOND,
                       record_decisions=True, device="cpu")(1, policy)
        assert torch.equal(off[1], want[1])      # the rider changes nothing
        _assert_equal(off[0], want[0])


# ---------------------------------------------------------------------------
# the port's counterparts of tests/test_online_admission.py
# ---------------------------------------------------------------------------

def test_submit_flush_matches_decide_slice():
    """The micro-batching front-end stacks submitted tickets onto exactly
    the decide_slice path: same arrivals, same decisions."""
    gen = _gen(3)
    stream = draw_arrival_stream(gen, PSMALL)
    ref = _engine(PSMALL)
    acc_ref = _drive(ref, stream, gen, PSMALL.n_steps)

    gen = _gen(3)
    stream = draw_arrival_stream(gen, PSMALL)
    host = bridge.to_numpy(stream)
    n_arr = host.n_arrivals
    eng = _engine(PSMALL)
    for t in range(PSMALL.n_steps):
        eng.tick(gen=gen)
        futs = [eng.submit(Arrival.from_stream(host, t, a))
                for a in range(int(n_arr[t]))]
        assert eng.n_pending == len(futs)
        eng.flush()
        got = [f.result(timeout=TIMEOUT) for f in futs]
        assert got == [bool(w) for w in acc_ref[t][:len(futs)]]
    assert eng.decisions == int(n_arr.sum())
    _assert_equal(eng.metrics(), ref.metrics())


def test_background_pump_resolves_futures():
    eng = _engine(PSMALL, ZEROTH, micro_batch=4)
    eng.tick(gen=_gen(0))
    gen = _gen(4)
    eng.start(interval_s=0.001)
    try:
        futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(10)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        eng.stop()
    assert all(r is True for r in results)   # empty cluster, thr=capacity
    assert eng.decisions == len(futs)
    assert eng._pump is None


def _zero_events(cfg):
    s = cfg.max_slots
    return ExternalEvents(core_deaths=np.zeros(s, np.float32),
                          spont_death=np.zeros(s, bool),
                          scaleout_cores=np.zeros(s, np.float32),
                          n_scaleouts=np.zeros(s, np.float32))


def test_external_event_ingestion():
    """Production path: observed departures/scale-outs via tick(events=)."""
    eng = _engine(PSMALL, ZEROTH, micro_batch=4)
    eng.tick(gen=_gen(0))
    fut = eng.submit(Arrival.draw(_gen(5), PSMALL))
    eng.flush()
    assert fut.result(timeout=TIMEOUT) is True

    ev = _zero_events(PSMALL)
    scaleout, n_req = ev.scaleout_cores.copy(), ev.n_scaleouts.copy()
    scaleout[0], n_req[0] = 5.0, 1.0      # sequential placement: first slot
    eng.tick(events=ev._replace(scaleout_cores=scaleout, n_scaleouts=n_req))
    m = eng.metrics()
    assert int(m.total_requests) == 1
    assert int(m.failed_requests) == 0
    assert int(m.alive_end) == 1

    kill = ev.spont_death.copy()
    kill[0] = True
    eng.tick(events=ev._replace(spont_death=kill))
    m = eng.metrics()
    assert int(m.alive_end) == 0
    assert int(m.n_departed) == 1
    with pytest.raises(ValueError, match="slot table"):
        eng.tick(events=ev._replace(core_deaths=np.zeros(3, np.float32)))


def test_tick_and_flush_protocol_errors():
    eng = _engine(PSMALL)
    with pytest.raises(RuntimeError, match="before the first tick"):
        eng.flush()
    with pytest.raises(RuntimeError, match="before the first tick"):
        eng.decide_slice(None, np.zeros(4, bool))
    with pytest.raises(ValueError, match="exactly one"):
        eng.tick()
    with pytest.raises(ValueError, match="exactly one"):
        eng.tick(gen=_gen(0), events=_zero_events(PSMALL))


def test_operating_point_roundtrip(tmp_path):
    rows = [
        {"name": operating_row_name("quick", "second"), "us_per_call": 0.0,
         "derived": format_operating_derived(0.08, 5_000.0, 5e-4)},
        {"name": operating_row_name("quick", "first"), "us_per_call": 0.0,
         "derived": format_operating_derived(1_850.0, 5_000.0, 5e-4)},
    ]
    path = tmp_path / "BENCH_quick.json"
    path.write_text(json.dumps({"scale": "quick", "rows": rows}))

    op = load_operating_point("second", "quick", bench_path=str(path))
    assert op.theta == 0.08 and op.capacity == 5_000.0 and op.tau == 5e-4
    assert op.theta_for(1_000.0) == 0.08
    first = load_operating_point("first", "quick", bench_path=str(path))
    assert first.theta_for(1_000.0) == pytest.approx(370.0)
    for kind in ("second", "first"):
        want = j_load_operating_point(kind, "quick", bench_path=str(path))
        got = load_operating_point(kind, "quick", bench_path=str(path))
        assert (got.theta, got.capacity, got.tau) == (
            want.theta, want.capacity, want.tau)
    # the committed artifact, read as data by both packages
    for kind in ("zeroth", "first", "second"):
        want, got = j_load_operating_point(kind), load_operating_point(kind)
        assert got is not None and got.theta == want.theta

    assert default_policy_param("second", 1_000.0,
                                bench_path=str(path)) == 0.08
    missing = tmp_path / "nope.json"
    with pytest.warns(UserWarning, match="falling back"):
        param = default_policy_param("second", 1_000.0,
                                     bench_path=str(missing))
    assert param == 0.15
    with pytest.warns(UserWarning):
        param = default_policy_param("zeroth", 1_000.0,
                                     bench_path=str(missing))
    assert param == 700.0


def test_event_path_seeds_derive_from_seed_chain():
    """The observed-events path derives each window's seed from (seed,
    tick): same seed, same chain; different seeds, different chains; the
    chain advances every tick."""
    ev = _zero_events(PSMALL)
    e_a, e_b, e_a2 = (_engine(PSMALL, ZEROTH, seed=s) for s in (0, 1, 0))
    for e in (e_a, e_b, e_a2):
        e.tick(events=ev)
    assert e_a._window_seed == e_a2._window_seed == window_seed(0, 0)
    assert e_a._window_seed != e_b._window_seed
    e_a.tick(events=ev)
    assert e_a._window_seed == window_seed(0, 1) != window_seed(0, 0)
    assert len({window_seed(s, t) for s in range(8) for t in range(8)}) == 64


def test_close_window_counter_idempotence():
    """metrics() twice in a row (or metrics() followed by tick()) cannot
    double-count a window's decisions."""
    eng = _engine(PSMALL, ZEROTH, micro_batch=4)
    eng.tick(gen=_gen(0))
    gen = _gen(11)
    futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(3)]
    eng.flush()
    assert all(f.result(timeout=TIMEOUT) for f in futs)
    m1, m2 = eng.metrics(), eng.metrics()
    assert int(m1.arrivals_accepted) == int(m2.arrivals_accepted) == 3
    eng.tick(gen=_gen(1))
    assert int(eng.metrics().arrivals_accepted) == 3


def test_flush_failure_resolves_futures_with_exception():
    """A decide chunk that raises fails the queued futures instead of
    leaving callers blocked forever."""
    eng = _engine(PSMALL, ZEROTH, micro_batch=2)
    eng.tick(gen=_gen(0))
    gen = _gen(1)
    futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(3)]
    boom = RuntimeError("decide exploded")

    def bad_decide(arrivals):
        raise boom

    eng._decide = bad_decide
    with pytest.raises(RuntimeError, match="decide exploded"):
        eng.flush()
    for f in futs:
        assert f.done()
        with pytest.raises(RuntimeError, match="decide exploded"):
            f.result(timeout=0)


def test_deadline_scheduler_fires_partial_and_full_batches():
    """flush_slo_ms switches start() to the deadline scheduler: paced
    sub-width load resolves via the deadline trigger within the SLO, and a
    width-sized burst fires on the width trigger."""
    eng = _engine(PSMALL, ZEROTH, micro_batch=4, flush_slo_ms=500.0)
    eng.tick(gen=_gen(0))
    gen = _gen(2)
    eng._decide([Arrival.draw(gen, PSMALL)])      # warm the path
    eng.start()
    try:
        futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(2)]
        t0 = time.monotonic()
        assert all(f.result(timeout=10) for f in futs)
        assert time.monotonic() - t0 <= 0.5 + 5.0    # resolved near the SLO
        futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(4)]
        assert all(isinstance(f.result(timeout=10), bool) for f in futs)
    finally:
        eng.stop()
    snap = eng.metrics_snapshot()["engine"]
    assert snap["deadline_misses"] == 0
    assert snap["flush_slo_ms"] == 500.0
    assert snap["n_shards"] == 1
    assert snap["decision_latency_seconds"].total == 6
    batches = snap["flush_batch_size"]
    assert batches.total == 2 and batches.sum == 6   # one partial, one full
    with pytest.raises(ValueError, match="flush_slo_ms"):
        _engine(PSMALL, ZEROTH, flush_slo_ms=-1.0)


def test_concurrency_stress_ticker_pump_submitters():
    """Ticker thread + background pump + submitter threads, with a short
    switch interval: no exception anywhere, every future resolves, and the
    decisions equal a serial replay (zero-event dynamics and threshold =
    capacity make the outcome interleaving-invariant: everything admits)."""
    eng = OnlineAdmissionEngine(PSMALL._replace(telemetry=True), PGRID,
                                ZEROTH, _policy(PSMALL, ZEROTH),
                                micro_batch=4, device="cpu")
    ev = _zero_events(PSMALL)
    eng.tick(events=ev)
    n_sub, per_sub = 6, 8
    gen = _gen(100)
    arrivals = [[Arrival.draw(gen, PSMALL) for _ in range(per_sub)]
                for _ in range(n_sub)]
    results: dict = {}
    errors: list = []
    stop_ticks = threading.Event()

    def ticker():
        try:
            while not stop_ticks.is_set():
                eng.tick(events=ev)
                eng.metrics_snapshot()        # scrape racing the pump
        except Exception as exc:              # pragma: no cover
            errors.append(exc)

    def submitter(i):
        try:
            futs = [eng.submit(a) for a in arrivals[i]]
            results[i] = [f.result(timeout=TIMEOUT) for f in futs]
        except Exception as exc:              # pragma: no cover
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start(interval_s=0.0)
        threads = [threading.Thread(target=ticker)]
        threads += [threading.Thread(target=submitter, args=(i,))
                    for i in range(n_sub)]
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=120)
        stop_ticks.set()
        threads[0].join(timeout=120)
        eng.stop()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(n_sub))
    assert all(all(r) for r in results.values())
    assert eng.decisions == n_sub * per_sub
    s = eng.metrics_snapshot()["telemetry"]
    assert s["n_admit"] == s["n_routed"] == n_sub * per_sub
    assert s["n_windows"] == eng.ticks
    assert int(eng.metrics().arrivals_accepted) == n_sub * per_sub


def test_tracer_gets_host_values_once_per_chunk(tmp_path):
    """With a tracer attached, each decision is one JSONL record whose
    score, threshold and fit flag are host values (the chunk's diagnostics
    were copied to the host once, not indexed on the device per record)."""
    recorded = []

    class SpyTracer:
        def record(self, **fields):
            recorded.append(fields)

    width = 16
    cfg = PSMALL._replace(max_arrivals=width)
    eng = OnlineAdmissionEngine(cfg, PGRID, SECOND, _policy(cfg),
                                micro_batch=width, tracer=SpyTracer(),
                                device="cpu")
    eng.tick(gen=_gen(0))
    gen = _gen(1)
    futs = [eng.submit(Arrival.draw(gen, cfg)) for _ in range(width)]
    eng.flush()
    assert len(recorded) == width
    for rec, fut in zip(recorded, futs):
        for field in ("score", "threshold", "fits"):
            assert isinstance(rec[field], np.generic), field
        assert rec["verdict"] == fut.result(timeout=0)
        assert rec["threshold"] == np.float32(RHO)

    path = tmp_path / "decisions.jsonl"
    with DecisionTracer(path) as tracer:
        eng = OnlineAdmissionEngine(cfg, PGRID, SECOND, _policy(cfg),
                                    micro_batch=4, tracer=tracer,
                                    device="cpu")
        eng.tick(gen=_gen(0))
        futs = [eng.submit(Arrival.draw(gen, cfg)) for _ in range(6)]
        eng.flush()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["req_id"] for r in recs] == list(range(1, 7))
    assert [r["verdict"] for r in recs] == [f.result(timeout=0)
                                            for f in futs]
    assert [r["batch_size"] for r in recs] == [4] * 4 + [2] * 2
    assert all(set(r) >= {"step", "policy_kind", "latency_s", "score",
                          "threshold", "fits"} for r in recs)


def test_snapshot_without_telemetry_has_no_rider():
    eng = _engine(PSMALL, ZEROTH)
    eng.tick(gen=_gen(0))
    snap = eng.metrics_snapshot()
    assert "telemetry" not in snap
    assert snap["engine"]["n_ticks"] == 1


def test_naive_lane_refreshes_every_request():
    """The naive lane: one aggregate recompute and a width-1 decision per
    request, and no refresh on the tick schedule."""
    eng = _engine(PSMALL, naive=True)
    calls = []
    refresh = eng.core.refresh_aggregates

    def counting(cs):
        calls.append(1)
        return refresh(cs)

    eng.core = eng.core._replace(refresh_aggregates=counting)
    eng.tick(gen=_gen(0))
    gen = _gen(6)
    futs = [eng.submit(Arrival.draw(gen, PSMALL)) for _ in range(5)]
    eng.flush()
    assert all(isinstance(f.result(timeout=0), bool) for f in futs)
    assert len(calls) == 5
    assert eng.n_refreshes == 0
    batches = eng.metrics_snapshot()["engine"]["flush_batch_size"]
    assert batches.total == 5 and batches.sum == 5


@pytest.mark.parametrize("kwargs, match", [
    (dict(shards=4), "item 5"),
    (dict(shards=2), "item 5"),
    (dict(drift_detector=object()), "item 8"),
])
def test_unported_options_raise(kwargs, match, monkeypatch):
    """Options once left out, now ported. Item 8's ``drift_detector=``
    (``tests/test_torch_drift.py``): the engine refuses it only without
    ``cfg.telemetry``, as the JAX engine does. Item 5's ``shards=`` (the
    mesh, ``tests/test_torch_mesh.py``): without that many devices it
    raises, naming the variable that asks for logical ones; with it, the
    slot table is sharded over them."""
    if match == "item 8":
        with pytest.raises(ValueError, match="telemetry"):
            _engine(PSMALL, **kwargs)
        return
    monkeypatch.delenv("REPRO_TORCH_DEVICE_COUNT", raising=False)
    with pytest.raises(ValueError, match="REPRO_TORCH_DEVICE_COUNT"):
        _engine(PSMALL, **kwargs)
    monkeypatch.setenv("REPRO_TORCH_DEVICE_COUNT", str(kwargs["shards"]))
    eng = _engine(PSMALL, **kwargs)
    assert eng.n_shards == kwargs["shards"]
    assert len(eng.core.mesh.devices) == kwargs["shards"]
    assert eng.metrics_snapshot()["engine"]["n_shards"] == kwargs["shards"]


def test_fleet_configuration_raises():
    """A fleet engine is ported (``tests/test_torch_fleet_engine.py``); a
    fleet with ``shards=`` is refused, as the JAX engine refuses it (a
    fleet spreads its state over the cluster axis), and so is a router
    without a fleet."""
    from repro_torch.core import fleet_policy
    from repro_torch.sim import FleetConfig, LeastUtilizedRouter

    caps = (300.0, 200.0)
    fleet = FleetConfig(base=PSMALL, capacities=caps)
    policy = fleet_policy(SECOND, capacities=caps, rho=RHO)
    eng = OnlineAdmissionEngine(fleet, PGRID, SECOND, policy, device="cpu")
    assert eng.fleet and eng.n_c == 2
    with pytest.raises(ValueError, match="fleet"):
        OnlineAdmissionEngine(fleet, PGRID, SECOND, policy, shards=2,
                              device="cpu")
    with pytest.raises(ValueError, match="FleetConfig"):
        _engine(PSMALL, router=LeastUtilizedRouter())


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the engine runs in chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OnlineAdmissionEngine(PSMALL, PGRID, SECOND, _policy(PSMALL))
