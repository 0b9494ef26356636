"""The port's device mesh for the admission system, on the CPU.

A mesh is one process driving an explicit tuple of devices
(``repro_torch.device``); ``REPRO_TORCH_DEVICE_COUNT=N`` gives N logical CPU
devices, as ``XLA_FLAGS=--xla_force_host_platform_device_count=N`` gives the
JAX package N virtual ones. Each shard or chunk on a logical device holds
tensors of its own.

* Validation, as ``tests/test_online_admission.py``'s: ``slot_mesh(0)``, too
  many shards (naming the variable), a two-axis mesh, ``max_slots`` the
  shard count does not divide, a lane other than the fused one, a fleet
  engine with ``shards=``.
* The sharded engine against the unsharded port engine, bit for bit:
  decisions, every refreshed aggregate, metrics and the telemetry rider, at
  the JAX package's slow test's configuration (32 slots over 8 shards) and
  at tables whose 512-slot blocks cross shard edges.
* The sharded engine against the JAX engine on the JAX package's events
  and arrivals (``tests/torch_lockstep.py``): decisions and counts equal,
  the metrics within ``RTOL_METRICS``. The slow lane also runs the JAX
  package's own ``shards=8`` engine (a subprocess with 8 XLA devices) on
  the same draws.
* Batches split over devices equal one batch bit for bit: ragged, with
  streams, a fleet batch, ``calibrate`` (the ragged 3 x 7 flat batch of
  ``tests/test_tuning.py``), ``simulate_plan``, ``simulate_trace_plan`` and
  the importance probe.
* The daemon with ``--shards 4`` under the variable.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, geometric_grid
from repro.core import make_policy as j_make_policy
from repro.serve import ExternalEvents as JExternalEvents
from repro.serve import OnlineAdmissionEngine as JEngine
from repro.sim import SimConfig
from repro_torch import bridge
from repro_torch.core import fleet_policy, make_policy
from repro_torch.device import DEVICE_COUNT_VAR, Mesh, visible_devices
from repro_torch.launch import admission_daemon as D
from repro_torch.serve import ExternalEvents, OnlineAdmissionEngine
from repro_torch.sim import (draw_arrival_stream, make_admission_core,
                             make_config, make_fleet_config, make_fleet_run,
                             make_run, run_batch, run_keyed_batch, slot_mesh,
                             split_seeds)
from repro_torch.sim import importance as PI
from repro_torch.sim import simulator as S
from repro_torch.sim.simulator import _steps
from repro_torch.tuning import calibrate
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

GRID = geometric_grid(24.0, 3 * 30 * 24.0, 12)
PGRID = np.array(GRID)
RHO = 0.05
RTOL_METRICS = 1e-5          # tests/test_torch_admission.py's
COUNTS = ("total_requests", "failed_requests", "arrivals_accepted",
          "arrivals_rejected", "slot_overflow", "n_departed", "alive_end",
          "fail_trace")
# tests/test_online_admission.py's slow test: 32 slots, telemetry, K = 1
SLOW_CFG = make_config(capacity=500.0, arrival_rate=0.08,
                       horizon_hours=6 * 24.0, dt=24.0, max_slots=32,
                       max_arrivals=4, d_points=8, agg_refresh_steps=1,
                       telemetry=True, agg_backend="fused")
# tests/test_online_admission.py's CFG (JAX), for the reference's draws
J_CFG = SimConfig(capacity=500.0, arrival_rate=0.08,
                  horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                  max_arrivals=4, d_points=8, priors=AZURE_PRIORS,
                  agg_refresh_steps=3, telemetry=True)
BATCH_CFG = make_config(capacity=500.0, arrival_rate=0.08,
                        horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                        max_arrivals=4, d_points=8, agg_refresh_steps=3)


@pytest.fixture
def logical(monkeypatch):
    """``n`` logical CPU devices for the rest of the test."""
    def set_count(n):
        monkeypatch.setenv(DEVICE_COUNT_VAR, str(n))
        return ["cpu"] * n
    return set_count


def _policy(cfg):
    return make_policy(SECOND, rho=RHO, capacity=cfg.capacity)


# ---------------------------------------------------------------------------
# devices and validation
# ---------------------------------------------------------------------------

def test_visible_devices_reads_the_variable_at_each_call(monkeypatch):
    monkeypatch.delenv(DEVICE_COUNT_VAR, raising=False)
    assert visible_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setenv(DEVICE_COUNT_VAR, "8")
    assert visible_devices("cpu") == [torch.device("cpu")] * 8
    monkeypatch.setenv(DEVICE_COUNT_VAR, "1")
    assert visible_devices("cpu") == [torch.device("cpu")]
    for bad in ("0", "-2", "many"):
        monkeypatch.setenv(DEVICE_COUNT_VAR, bad)
        with pytest.raises(ValueError, match=DEVICE_COUNT_VAR):
            visible_devices("cpu")


def test_shards_validation_errors(monkeypatch, logical):
    monkeypatch.delenv(DEVICE_COUNT_VAR, raising=False)
    pol = _policy(SLOW_CFG)
    # more shards than devices: names the variable that gives more
    with pytest.raises(ValueError, match=DEVICE_COUNT_VAR):
        OnlineAdmissionEngine(SLOW_CFG, PGRID, SECOND, pol, shards=2,
                              device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        slot_mesh(0, device="cpu")
    devices = logical(8)
    two_axes = Mesh(tuple(torch.device(d) for d in devices[:4]),
                    ("a", "b"))
    with pytest.raises(ValueError, match="exactly one axis"):
        make_admission_core(SLOW_CFG, PGRID, SECOND, mesh=two_axes)
    with pytest.raises(ValueError, match="divisible"):
        make_admission_core(SLOW_CFG._replace(max_slots=30), PGRID, SECOND,
                            mesh=slot_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="fused"):
        make_admission_core(SLOW_CFG._replace(agg_backend="kernel"), PGRID,
                            SECOND, mesh=slot_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="one run"):
        make_admission_core(SLOW_CFG, PGRID, SECOND,
                            mesh=slot_mesh(4, device="cpu")).init(3)
    # fleet engines spread state over the cluster axis, not slot shards
    fleet = make_fleet_config((300.0, 200.0), **{
        k: v for k, v in SLOW_CFG._asdict().items()
        if k not in ("capacity", "priors")})
    fpol = fleet_policy(SECOND, capacities=fleet.capacities, rho=RHO)
    with pytest.raises(ValueError, match="fleet"):
        OnlineAdmissionEngine(fleet, PGRID, SECOND, fpol, shards=2,
                              device="cpu")


# ---------------------------------------------------------------------------
# the sharded engine against the unsharded port engine, bit for bit
# ---------------------------------------------------------------------------

def _drive(cfg, shards, seed=1, tracer=None):
    """An engine ticked with ``make_run``'s generator, deciding each step's
    slice of its stream; returns (accepts, every refreshed aggregate, the
    metrics, the rider, the snapshot)."""
    gen = torch.Generator().manual_seed(seed)
    stream = draw_arrival_stream(gen, cfg)
    eng = OnlineAdmissionEngine(cfg, PGRID, SECOND, _policy(cfg),
                                shards=shards, tracer=tracer, device="cpu")
    refreshed = []
    refresh = eng.core.refresh_aggregates

    def recording(cs):
        cs = refresh(cs)
        refreshed.append((cs.agg_el.clone(), cs.agg_vl.clone()))
        return cs

    eng.core = eng.core._replace(refresh_aggregates=recording)
    n_arr = stream.n_arrivals.numpy()
    lanes = np.arange(cfg.max_arrivals)
    accepts = [None] * cfg.n_steps
    for t, slice_t in enumerate(_steps(stream)):
        eng.tick(gen=gen)
        accepts[t] = eng.decide_slice(slice_t, lanes < n_arr[t])
    return (np.stack(accepts), refreshed, eng.metrics(), eng._cs.tel,
            eng.metrics_snapshot())


def _assert_same(one, sharded, n_shards):
    (a1, r1, m1, t1, s1), (an, rn, mn, tn, sn) = one, sharded
    np.testing.assert_array_equal(a1, an)
    assert len(r1) == len(rn) > 0
    for (el1, vl1), (eln, vln) in zip(r1, rn):
        assert torch.equal(el1, eln) and torch.equal(vl1, vln)
    for name in m1._fields:
        assert torch.equal(getattr(m1, name), getattr(mn, name)), name
    for x, y in zip(t1, tn):
        assert torch.equal(x, y)
    assert s1["telemetry"] == sn["telemetry"]
    assert sn["engine"]["n_shards"] == n_shards
    assert s1["engine"]["n_shards"] == 1


def test_sharded_engine_matches_unsharded_on_logical_devices(logical):
    """The JAX package's slow test's configuration on 8 logical devices:
    4 slots a shard, every step refreshed, the rider on; the traced decide
    path (a tracer attached) too."""
    import io

    from repro_torch.obs import DecisionTracer

    logical(8)
    one = _drive(SLOW_CFG, None)
    sharded = _drive(SLOW_CFG, 8)
    _assert_same(one, sharded, 8)
    assert one[0].any() and one[2].alive_end > 0
    traced = [_drive(SLOW_CFG, n, tracer=DecisionTracer(io.StringIO()))
              for n in (None, 8)]
    _assert_same(*traced, 8)
    np.testing.assert_array_equal(traced[1][0], one[0])


@pytest.mark.parametrize("slots,n_shards", [(2048, 4), (1536, 8), (1200, 6)],
                         ids=["2048x4", "1536x8", "1200x6-padded"])
def test_sharded_engine_matches_unsharded_across_blocks(logical, slots,
                                                        n_shards):
    """Tables past one 512-slot block: 2,048 slots over 4 shards (a block a
    shard), 1,536 over 8 (each block over 2.67 shards) and 1,200 over 6
    (the last block padded): the gathered reduction keeps the unsharded
    lane's left fold of blocks."""
    logical(n_shards)
    cfg = make_config(capacity=200_000.0, arrival_rate=12.0,
                      horizon_hours=48 * 6.0, dt=6.0, max_slots=slots,
                      max_arrivals=64, d_points=8, agg_refresh_steps=2,
                      telemetry=True, agg_backend="fused")
    one = _drive(cfg, None)
    _assert_same(one, _drive(cfg, n_shards), n_shards)
    # deployments live in more than the first shard
    assert float(one[2].alive_end) > slots // n_shards


def test_sharded_core_keeps_its_shards_apart(logical):
    """Each [S] leaf of a sharded table is one tensor a shard, of S / n
    slots, none a view of another's storage; the replicated leaves are
    held once."""
    from repro_torch.sim.core import Shards

    devices = logical(4)
    core = make_admission_core(SLOW_CFG, PGRID, SECOND,
                               mesh=slot_mesh(4, device="cpu"))
    assert core.mesh.devices == tuple(torch.device(d) for d in devices)
    cs = core.refresh_aggregates(core.init())
    for leaf in (cs.slots.alive, cs.slots.cores, *cs.slots.params,
                 *cs.slots.bel):
        assert isinstance(leaf, Shards) and len(leaf) == 4
        assert all(x.shape == (8,) for x in leaf)
        assert len({x.untyped_storage().data_ptr() for x in leaf}) == 4
    assert isinstance(cs.slots.core_hours, torch.Tensor)
    assert cs.agg_el.shape == (len(PGRID),)


# ---------------------------------------------------------------------------
# against the JAX engine, on the JAX package's draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_draws():
    """The JAX package's stream (numpy [T, A] leaves) and per-step events
    (numpy [S] leaves) of the golden SECOND run (seed 1, K = 3)."""
    stream, events = reference_draws(J_CFG, GRID, SECOND,
                                     [jax.random.PRNGKey(1)], [RHO])
    stream = type(stream)(*(type(x)(*(y[0] for y in x))
                            if isinstance(x, tuple) else x[0]
                            for x in stream))
    return stream, [type(ev)(*(x[0] for x in ev)) for ev in events]


def _drive_events(eng, stream, events, slices, external):
    accepts = []
    for t, ev in enumerate(events):
        eng.tick(events=external(core_deaths=ev.core_deaths,
                                 spont_death=ev.spont_death,
                                 scaleout_cores=ev.scaleout_cores,
                                 n_scaleouts=ev.n_scaleouts))
        valid = np.arange(J_CFG.max_arrivals) < int(stream.n_arrivals[t])
        accepts.append(np.asarray(eng.decide_slice(slices[t], valid)))
    return np.stack(accepts), eng.metrics(), eng.metrics_snapshot()


def _port_on_jax_draws(stream, events, shards):
    cfg = port_config(J_CFG)
    eng = OnlineAdmissionEngine(cfg, PGRID, SECOND, _policy(cfg),
                                shards=shards, device="cpu")
    return _drive_events(eng, stream, events,
                         _steps(bridge.from_reference(stream)),
                         ExternalEvents)


def _assert_matches_jax(got, want):
    (t_acc, t_m, t_snap), (j_acc, j_m) = got, want[:2]
    np.testing.assert_array_equal(t_acc, j_acc)
    assert j_acc.any() and not j_acc.all()
    for name in j_m._fields:
        g, w = getattr(t_m, name).numpy(), np.asarray(getattr(j_m, name))
        if name in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL_METRICS,
                                       err_msg=name)


def test_sharded_engine_matches_jax_engine(jax_draws, logical):
    """The port's engine with its 96 slots over 8 logical devices against
    the JAX engine, both ingesting the JAX package's events and deciding
    its arrivals (the JAX package's own slow test holds its sharded engine
    equal to its unsharded one)."""
    stream, events = jax_draws
    j_eng = JEngine(J_CFG, GRID, SECOND,
                    j_make_policy(SECOND, rho=RHO, capacity=J_CFG.capacity))
    want = _drive_events(j_eng, stream, events,
                         [jax.tree.map(lambda x: x[t], stream)
                          for t in range(len(events))], JExternalEvents)
    logical(8)
    got = _port_on_jax_draws(stream, events, 8)
    _assert_matches_jax(got, want)
    assert got[2]["telemetry"] == want[2]["telemetry"]
    assert got[2]["engine"]["n_shards"] == 8


_JAX_SHARDED = """
import json, sys
import jax, numpy as np
from repro.core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from repro.serve import ExternalEvents, OnlineAdmissionEngine
from repro.sim import SimConfig, draw_arrival_stream

assert jax.device_count() == 8
cfg = SimConfig(**json.loads(sys.argv[1]), priors=AZURE_PRIORS)
z = np.load(sys.argv[2])
like = draw_arrival_stream(jax.random.PRNGKey(0), cfg)
leaves, tree = jax.tree_util.tree_flatten(like)
stream = jax.tree_util.tree_unflatten(
    tree, [z[f"stream_{i}"] for i in range(len(leaves))])
eng = OnlineAdmissionEngine(cfg, geometric_grid(24.0, 3 * 30 * 24.0, 12),
                            SECOND, make_policy(SECOND, rho=0.05,
                                                capacity=cfg.capacity),
                            shards=8)
acc = []
for t in range(cfg.n_steps):
    eng.tick(events=ExternalEvents(*(z[f"{k}_{t}"] for k in
                                     ExternalEvents._fields)))
    valid = np.arange(cfg.max_arrivals) < int(stream.n_arrivals[t])
    acc.append(np.asarray(eng.decide_slice(
        jax.tree.map(lambda x: x[t], stream), valid)))
m = eng.metrics()
np.savez(sys.argv[3], accept=np.stack(acc),
         **{f"m_{k}": np.asarray(getattr(m, k)) for k in m._fields})
print("OK", eng.n_shards)
"""


@pytest.mark.slow
def test_sharded_engine_matches_jax_sharded_engine(jax_draws, logical,
                                                   tmp_path):
    """The JAX package's ``shards=8`` engine (a subprocess with 8 XLA
    devices) against the port's on 8 logical devices, on the same events
    and arrivals."""
    stream, events = jax_draws
    arrays = {f"stream_{i}": np.asarray(x) for i, x in
              enumerate(jax.tree_util.tree_leaves(stream))}
    for t, ev in enumerate(events):
        arrays.update({f"{k}_{t}": np.asarray(getattr(ev, k)) for k in
                       JExternalEvents._fields})
    np.savez(tmp_path / "draws.npz", **arrays)
    fields = {k: v for k, v in J_CFG._asdict().items() if k != "priors"}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SHARDED, json.dumps(fields),
         str(tmp_path / "draws.npz"), str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["OK", "8"]
    z = np.load(tmp_path / "out.npz")
    from repro.sim.simulator import RunMetrics
    want = (z["accept"], RunMetrics(*(z[f"m_{k}"] for k in
                                      RunMetrics._fields)))
    logical(8)
    _assert_matches_jax(_port_on_jax_draws(stream, events, 8), want)


# ---------------------------------------------------------------------------
# batches split over devices, bit for bit
# ---------------------------------------------------------------------------

def _equal_trees(a, b):
    if a is None or isinstance(a, torch.Tensor):
        assert (a is None and b is None) or torch.equal(a, b)
        return
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        _equal_trees(x, y)


def test_ragged_batch_over_devices_equals_one_batch(logical):
    """6 runs over 4 devices (padded to 8, the pad sliced off), one policy
    a run, decisions and the rider recorded: every output equal to one
    batch's."""
    cfg = BATCH_CFG._replace(telemetry=True)
    run = make_run(cfg, PGRID, SECOND, record_decisions=True, device="cpu")
    seeds = split_seeds(3, 6)
    policy = make_policy(SECOND, rho=[0.05, 0.01, 0.2, 0.3, 0.1, 0.02],
                         capacity=cfg.capacity)
    want = run(seeds, policy)
    got = run_keyed_batch(run, seeds, policy, devices=logical(4))
    _equal_trees(got, want)
    assert got[1].shape[0] == 6


def test_batch_with_streams_over_devices(logical):
    run = make_run(BATCH_CFG, PGRID, SECOND, device="cpu")
    seeds = [5, 6, 7, 8, 9]
    streams = [draw_arrival_stream(torch.Generator().manual_seed(100 + s),
                                   BATCH_CFG) for s in seeds]
    stacked = S._tree_map(lambda *xs: torch.stack(xs), *streams)
    want = run(seeds, _policy(BATCH_CFG), stream=stacked)
    got = run_keyed_batch(run, seeds, _policy(BATCH_CFG), streams=stacked,
                          devices=logical(2))
    _equal_trees(got, want)


def test_run_batch_splits_over_the_visible_devices(logical, monkeypatch):
    """``devices=None`` takes the variable's logical devices, through the
    one split path."""
    run = make_run(BATCH_CFG, PGRID, SECOND, device="cpu")
    want = run_batch(run, 0, _policy(BATCH_CFG), 5)
    splits = []
    split = S.shard_batch_over_devices
    monkeypatch.setattr(S, "shard_batch_over_devices",
                        lambda *a, **k: splits.append(len(a[1]))
                        or split(*a, **k))
    logical(4)
    _equal_trees(run_batch(run, 0, _policy(BATCH_CFG), 5), want)
    assert splits == [4]


def test_fleet_batch_over_devices(logical):
    """A batch of 5 fleet runs over 4 devices, the policy's [C] leaves
    shared: equal to one batch."""
    fcfg = make_fleet_config((300.0, 200.0), arrival_rate=0.1,
                             horizon_hours=20 * 24.0, dt=24.0, max_slots=48,
                             max_arrivals=4, d_points=8, agg_refresh_steps=2)
    run = make_fleet_run(fcfg, PGRID, SECOND, record_decisions=True,
                         device="cpu")
    policy = fleet_policy(SECOND, capacities=fcfg.capacities, rho=RHO)
    seeds = [11, 12, 13, 14, 15]
    _equal_trees(run_keyed_batch(run, seeds, policy, devices=logical(4)),
                 run(seeds, policy))


@pytest.mark.parametrize("thetas,n_keys", [([0.3, 0.05, 0.01], 7),
                                           ([0.1, 0.02], 4)],
                         ids=["ragged-3x7", "2x4"])
def test_calibrate_over_devices_equals_one_device(logical, thetas, n_keys):
    """``calibrate`` over 8 devices against one: the same theta and the
    same rates, bit for bit; the ragged 3 x 7 flat batch is padded to 24,
    never run unsplit."""
    run = make_run(BATCH_CFG, PGRID, SECOND, device="cpu")
    keys = split_seeds(7, n_keys)
    kw = dict(capacity=BATCH_CFG.capacity, tau=5e-3, thetas=thetas)
    want = calibrate(run, SECOND, keys, devices=["cpu"], **kw)
    got = calibrate(run, SECOND, keys, devices=logical(8), **kw)
    assert got.theta == want.theta and got.n_sims == want.n_sims
    for a, b in zip(got.stages, want.stages):
        np.testing.assert_array_equal(a.agg_fail, b.agg_fail)
        np.testing.assert_array_equal(a.util, b.util)
    np.testing.assert_array_equal(got.util_runs, want.util_runs)


def test_importance_probe_and_plan_over_devices(logical):
    """The probe over 4 devices against one (a batch of 8 split, a ragged
    batch of 6 on the first device), and the plan's simulation split."""
    cfg = make_config(capacity=300.0, arrival_rate=0.2,
                      horizon_hours=120 * 24.0, dt=24.0, max_slots=64,
                      max_arrivals=8, d_points=8)
    grid = np.array(geometric_grid(24.0, 3 * 120 * 24.0, 12))
    kw = dict(quotas=(2, 2, 2), edges_frac=(2.0, 4.0), n_probe=14,
              probe_batch=8, device="cpu")
    want = PI.make_importance_plan(5, cfg, grid, devices=["cpu"], **kw)
    got = PI.make_importance_plan(5, cfg, grid, devices=logical(4), **kw)
    np.testing.assert_array_equal(got.bm_probe, want.bm_probe)
    np.testing.assert_array_equal(got.keys, want.keys)
    assert len(want.keys) >= 3
    run = make_run(cfg, grid, SECOND, device="cpu")
    policy = make_policy(SECOND, rho=RHO, capacity=cfg.capacity)
    _equal_trees(PI.simulate_plan(run, want, policy, devices=logical(4)),
                 PI.simulate_plan(run, want, policy, devices=["cpu"]))


def test_trace_plan_over_devices(logical):
    from repro_torch.traces import TraceSpec, synthesize_scenario, \
        trace_to_stream

    cfg = make_config(capacity=300.0, arrival_rate=0.2,
                      horizon_hours=60 * 24.0, dt=24.0, max_slots=64,
                      max_arrivals=8, d_points=8)
    spec = TraceSpec(horizon_hours=60 * 24.0, arrival_rate=0.2,
                     max_deployments=128, max_events=8, priors=cfg.priors)
    streams = [trace_to_stream(synthesize_scenario(s, "baseline", spec,
                                                   device="cpu"), cfg)[0]
               for s in range(5)]
    plan = PI.make_trace_ensemble_plan(3, cfg, PGRID, streams,
                                       quotas=(2, 1, 1),
                                       edges_frac=(1.0, 1.3),
                                       runs_per_trace=2, probe_batch=4)
    run = make_run(cfg, PGRID, SECOND, device="cpu")
    policy = make_policy(SECOND, rho=RHO, capacity=cfg.capacity)
    _equal_trees(
        PI.simulate_trace_plan(run, plan, streams, policy,
                               devices=logical(3)),
        PI.simulate_trace_plan(run, plan, streams, policy, devices=["cpu"]))


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

def test_daemon_with_shards(logical):
    logical(4)
    args = D.parse_args(["--capacity", "500", "--hours", "240", "--dt", "24",
                         "--max-slots", "96", "--micro-batch", "4",
                         "--arrival-rate", "0.08", "--param", "0.05",
                         "--telemetry", "--shards", "4", "--device", "cpu"])
    engine, stream, gen, _ = D.build_engine(args)
    assert engine.n_shards == 4 and len(engine.core.mesh.devices) == 4
    summary = D.serve_loop(engine, stream, gen)
    assert summary["decisions"] == int(stream.n_arrivals.sum())
    line = json.loads(D.snapshot_log_line(engine.metrics_snapshot()))
    assert line["engine"]["n_shards"] == 4
    assert line["telemetry"]["n_routed"] == summary["decisions"]
