"""The port's online engine in fleet mode, and the daemon's ``--fleet``.

* Against the JAX fleet engine: both engines ingest the same observed
  per-cluster events (``tick(events=...)``, [C, S]), decide the same
  arrival tickets and route them on the same router draws (the JAX
  engine's, from its window keys; the port's router takes them through
  ``decide_slice(route_draws=...)`` or a router that replays them), through
  ``decide_slice``, ``submit``/``flush`` and the naive lane. The events and
  tickets are the JAX package's own draws of a three-cluster fleet
  (``tests/torch_lockstep.py``). Accept masks equal, the metrics' counts
  equal and their float32 sums within rtol 1e-5, the telemetry summaries
  (with ``per_cluster``) equal, and the Prometheus text's cluster gauges
  equal.
* Online equals offline in the port, bit for bit: a fleet engine ticked
  with ``make_fleet_run``'s generator and deciding its stream takes
  ``make_fleet_run``'s decisions and gives its ``FleetMetrics`` and rider,
  for every router, with the rider off and on.
* The daemon's ``--fleet`` on the CPU.
"""
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import SECOND
from repro.core import fleet_policy as j_fleet_policy
from repro.core import geometric_grid
from repro.obs import snapshot_to_prometheus as j_snapshot_to_prometheus
from repro.serve import Arrival as JArrival
from repro.serve import ExternalEvents as JExternalEvents
from repro.serve import OnlineAdmissionEngine as JEngine
from repro.sim import ROUTERS as J_ROUTERS
from repro.sim import FleetConfig as JFleetConfig
from repro.sim import make_config as j_make_config
from repro_torch import bridge
from repro_torch.core import fleet_policy, make_policy
from repro_torch.launch import admission_daemon as D
from repro_torch.obs import snapshot_to_prometheus
from repro_torch.serve import Arrival, ExternalEvents, OnlineAdmissionEngine
from repro_torch.sim import (ROUTERS, FleetConfig, FleetMetrics,
                             draw_arrival_stream, make_fleet_run,
                             stream_config)
from repro_torch.sim.simulator import _steps
from torch_lockstep import (engine_route_draws, fleet_policies,
                            port_fleet_config, reference_fleet_draws)

CFG = j_make_config(capacity=500.0, arrival_rate=0.12,
                    horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                    max_arrivals=4, d_points=8, agg_refresh_steps=3)
GRID = geometric_grid(24.0, 3 * 30 * 24.0, 12)
PGRID = np.asarray(GRID)
CAPS = (250.0, 150.0, 100.0)
RHO = 0.05
SEED = 0
RTOL = 1e-5
COUNTS = ("total_requests", "failed_requests", "arrivals_accepted",
          "arrivals_rejected", "rejected_by_all", "slot_overflow",
          "n_departed", "alive_end", "fail_trace")
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def jax_draws():
    """The JAX package's stream (numpy [T, A] leaves) and per-step events
    (numpy [C, S] leaves) of a three-cluster SECOND fleet (seed 1)."""
    fcfg = JFleetConfig(base=CFG, capacities=CAPS)
    stream, events, _ = reference_fleet_draws(
        fcfg, GRID, SECOND, jax.random.PRNGKey(1)[None],
        fleet_policies(SECOND, CAPS, [RHO]), "least_utilized")
    first = lambda tree: type(tree)(*(
        first(x) if isinstance(x, tuple) else x[0] for x in tree))
    return first(stream), [first(ev) for ev in events]


class ReplayedDraws:
    """A port router that draws what the JAX fleet engine's router draws in
    the open window (every slice of a window routes from one key)."""

    def __init__(self, name, engine_ticks):
        self.base = ROUTERS[name]()
        self.name, self.ticks = name, engine_ticks

    def draw(self, gen, ctx):
        return engine_route_draws(self.name, SEED, self.ticks() - 1,
                                  len(CAPS), ctx.c0.shape[-1])

    def assign(self, ctx, draws):
        return self.base.assign(ctx, draws)


def _drive_both(path, name, stream, events, telemetry=True):
    """Drive a JAX fleet engine and a port fleet engine on the same events,
    tickets and router draws; returns (accepts, metrics, snapshot) of
    each."""
    cfg = CFG._replace(telemetry=telemetry)
    jfcfg = JFleetConfig(base=cfg, capacities=CAPS)
    naive = path == "naive"
    j_eng = JEngine(jfcfg, GRID, SECOND,
                    j_fleet_policy(SECOND, capacities=CAPS, rho=RHO),
                    router=J_ROUTERS[name](), naive=naive, seed=SEED)
    t_eng = OnlineAdmissionEngine(
        port_fleet_config(jfcfg), PGRID, SECOND,
        fleet_policy(SECOND, capacities=CAPS, rho=RHO), naive=naive,
        router=ROUTERS[name](), seed=SEED, device="cpu")
    if path != "decide_slice":
        t_eng.router = ReplayedDraws(name, lambda: t_eng.ticks)
    t_stream = bridge.from_reference(stream)
    n_lanes = cfg.max_arrivals
    out = {}
    for who, eng, arrival, ext in (("jax", j_eng, JArrival, JExternalEvents),
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
                if who == "jax":
                    got = eng.decide_slice(
                        jax.tree.map(lambda x: x[t], stream), valid)
                else:
                    got = eng.decide_slice(
                        _steps(t_stream)[t], valid,
                        route_draws=engine_route_draws(name, SEED, t,
                                                       len(CAPS), n_lanes))
                accepts.append(np.asarray(got))
                continue
            futs = [eng.submit(arrival.from_stream(stream, t, a))
                    for a in range(n)]
            eng.flush()
            row = np.zeros(n_lanes, bool)
            row[:n] = [f.result(timeout=TIMEOUT) for f in futs]
            accepts.append(row)
        out[who] = (np.stack(accepts), eng.metrics(),
                    eng.metrics_snapshot())
    return out


def _assert_metrics(t_m, j_m):
    for name in j_m._fields:
        if name == "per_cluster":
            _assert_metrics(t_m.per_cluster, j_m.per_cluster)
            continue
        got, want = getattr(t_m, name).numpy(), np.asarray(getattr(j_m, name))
        if name in COUNTS:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)


def _cluster_lines(text):
    return [line for line in text.splitlines() if 'cluster="' in line]


@pytest.mark.parametrize("path, name", [
    ("decide_slice", "least_utilized"), ("decide_slice", "power_of_two"),
    ("decide_slice", "random"), ("decide_slice", "cascade"),
    ("submit", "power_of_two"), ("submit", "cascade"),
    ("naive", "least_utilized"), ("naive", "random")])
def test_fleet_engine_matches_jax_fleet_engine(jax_draws, path, name):
    stream, events = jax_draws
    out = _drive_both(path, name, stream, events)
    (j_acc, j_m, j_snap), (t_acc, t_m, t_snap) = out["jax"], out["port"]
    np.testing.assert_array_equal(t_acc, j_acc)
    valid = np.arange(CFG.max_arrivals)[None] < np.asarray(
        stream.n_arrivals)[:, None]
    assert j_acc.any() and (valid & ~j_acc).any()
    assert isinstance(t_m, FleetMetrics)
    _assert_metrics(t_m, j_m)
    assert t_snap["telemetry"] == j_snap["telemetry"]
    assert len(t_snap["telemetry"]["per_cluster"]["n_routed"]) == len(CAPS)
    for key in ("n_requests", "n_flushes", "n_refreshes", "n_ticks",
                "queue_depth", "deadline_misses", "flush_slo_ms",
                "n_shards"):
        assert t_snap["engine"][key] == j_snap["engine"][key], key
    # the Prometheus text's per-cluster gauges, from the same summaries
    lines = _cluster_lines(snapshot_to_prometheus(t_snap))
    assert lines == _cluster_lines(j_snapshot_to_prometheus(j_snap))
    assert sum('cluster_routed_count{cluster="' in x for x in lines) == 3


# ---------------------------------------------------------------------------
# online equals offline in the port, bit for bit
# ---------------------------------------------------------------------------

PFLEET = FleetConfig(base=bridge.from_reference(CFG), capacities=CAPS)


def _assert_equal(a, b, where=""):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, tuple):
            _assert_equal(x, y, f"{where}{name}.")
        else:
            assert torch.equal(x, y), where + name


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_fleet_engine_equals_make_fleet_run_bit_for_bit(name, telemetry):
    fcfg = PFLEET._replace(base=PFLEET.base._replace(telemetry=telemetry))
    policy = fleet_policy(SECOND, capacities=CAPS, rho=RHO)
    want = make_fleet_run(fcfg, PGRID, SECOND, router=ROUTERS[name](),
                          record_decisions=True, device="cpu")(3, policy)
    gen = torch.Generator().manual_seed(3)
    stream = draw_arrival_stream(gen, stream_config(fcfg))
    eng = OnlineAdmissionEngine(fcfg, PGRID, SECOND, policy,
                                router=ROUTERS[name](), device="cpu")
    lanes = np.arange(fcfg.base.max_arrivals)
    accepts = []
    for t, slice_t in enumerate(_steps(stream)):
        eng.tick(gen=gen)
        accepts.append(eng.decide_slice(slice_t,
                                        lanes < int(slice_t.n_arrivals)))
    np.testing.assert_array_equal(np.stack(accepts),
                                  want[1].numpy().any(axis=1))
    _assert_equal(eng.metrics(), want[0])
    if telemetry:
        _assert_equal(eng._cs.tel, want[3])


def test_fleet_engine_refuses_bad_inputs():
    policy = fleet_policy(SECOND, capacities=CAPS, rho=RHO)
    with pytest.raises(ValueError, match="FleetConfig"):
        OnlineAdmissionEngine(PFLEET.base, PGRID, SECOND,
                              make_policy(SECOND, rho=RHO, capacity=500.0),
                              router=ROUTERS["random"](), device="cpu")
    with pytest.raises(ValueError, match="FleetConfig.capacities"):
        OnlineAdmissionEngine(PFLEET, PGRID, SECOND,
                              make_policy(SECOND, rho=RHO, capacity=500.0),
                              device="cpu")
    eng = OnlineAdmissionEngine(PFLEET, PGRID, SECOND, policy, device="cpu")
    s = PFLEET.base.max_slots
    bad = ExternalEvents(core_deaths=np.zeros(s, np.float32),
                         spont_death=np.zeros(s, bool),
                         scaleout_cores=np.zeros(s, np.float32),
                         n_scaleouts=np.zeros(s, np.float32))
    with pytest.raises(ValueError, match="shape"):
        eng.tick(events=bad)
    m = eng.metrics()
    assert m.util_trace.shape == (0,) and m.per_cluster.util_trace.shape == (
        3, 0)


def test_fleet_engine_pump_resolves_every_future():
    policy = fleet_policy(SECOND, capacities=CAPS, rho=RHO)
    eng = OnlineAdmissionEngine(PFLEET, PGRID, SECOND, policy, micro_batch=4,
                                device="cpu")
    gen = torch.Generator().manual_seed(5)
    eng.tick(gen=gen)
    eng.start()
    futs = [eng.submit(Arrival.draw(gen, PFLEET.base)) for _ in range(10)]
    results = [f.result(timeout=TIMEOUT) for f in futs]
    eng.stop()
    assert all(isinstance(r, bool) for r in results)
    assert eng.decisions == 10
    m = eng.metrics()
    assert float(m.arrivals_accepted) + float(m.arrivals_rejected) == 10.0


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

DAEMON_ARGS = ["--capacity", "500", "--hours", "240", "--dt", "24",
               "--max-slots", "96", "--micro-batch", "4",
               "--arrival-rate", "0.16", "--param", "0.05",
               "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--flush-slo-ms", "20"],
                                   ["--telemetry"]],
                         ids=["flush", "deadline", "telemetry"])
def test_daemon_fleet_on_the_cpu(extra):
    args = D.parse_args(DAEMON_ARGS + ["--fleet", "300,200"] + extra)
    engine, stream, gen, param = D.build_engine(args)
    assert engine.fleet and engine.n_c == 2 and param == 0.05
    assert engine.cfg.total_capacity == 500.0
    summary = D.serve_loop(engine, stream, gen, stop=threading.Event())
    assert summary["ticks"] == engine.base.n_steps == 10
    assert summary["decisions"] == int(stream.n_arrivals.sum())
    m = engine.metrics()
    assert isinstance(m, FleetMetrics)
    assert summary["admitted"] == int(m.arrivals_accepted)
    assert m.per_cluster.arrivals_accepted.shape == (2,)
    line = json.loads(D.snapshot_log_line(engine.metrics_snapshot()))
    assert line["engine"]["n_requests"] == engine.decisions
    if "--telemetry" in extra:
        text = snapshot_to_prometheus(engine.metrics_snapshot())
        assert 'repro_admission_cluster_routed_count{cluster="1"}' in text
    # the same arrivals, events and routing with flushes or deadlines
    if extra == ["--flush-slo-ms", "20"]:
        ref, stream, gen, _ = D.build_engine(D.parse_args(
            DAEMON_ARGS + ["--fleet", "300,200"]))
        assert D.serve_loop(ref, stream, gen)["admitted"] == \
            summary["admitted"]


def test_daemon_fleet_equals_make_fleet_run():
    """The daemon's fleet, ticked and flushed through its loop, takes
    ``make_fleet_run``'s decisions on the same seed."""
    args = D.parse_args(DAEMON_ARGS + ["--fleet", "300,200", "--seed", "4"])
    engine, stream, gen, _ = D.build_engine(args)
    D.serve_loop(engine, stream, gen)
    want = make_fleet_run(engine.cfg, engine.core.grid, SECOND,
                          device="cpu")(4, fleet_policy(
                              SECOND, capacities=(300.0, 200.0),
                              threshold=0.05, rho=0.05))
    _assert_equal(engine.metrics(), want)
