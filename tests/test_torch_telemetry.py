"""The port's observability layer against the JAX package's: the telemetry
rider's folds and ``make_run``'s rider, the Prometheus export, the tracer,
the logger, and the admission daemon.

* Folds: the same numpy-made inputs through both packages'
  ``mark_refresh`` / ``fold_window`` / ``fold_decisions`` give equal bits
  (every fold is one float32 add a counter).
* ``make_run`` with the rider: on the JAX package's draws of the golden
  runs, the port's rider summary equals the JAX package's ``make_run``
  rider summary; the rider changes no decision and no metric (one run and
  a batch); the counters obey the JAX package's conservation laws.
* Export: the same snapshot renders to the same Prometheus text in both
  packages, and the daemon's ``snapshot_log_line`` is the same line.
* Daemon: ``build_engine`` + ``serve_loop`` on the CPU, the CLI with
  ``--metrics-port 0`` scraped once and stopped by SIGTERM, and the flags
  left out (``--fleet``, ``--shards``) raising.
"""
import json
import logging
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, ZEROTH, geometric_grid
from repro.core import make_policy as j_make_policy
from repro.launch.admission_daemon import \
    snapshot_log_line as j_snapshot_log_line
from repro.obs import HostHistogram as JHostHistogram
from repro.obs import counters as JC
from repro.obs import snapshot_to_prometheus as j_snapshot_to_prometheus
from repro.obs import telemetry_summary as j_telemetry_summary
from repro.sim import SimConfig
from repro.sim import make_run as j_make_run
from repro_torch import bridge
from repro_torch.core import make_policy
from repro_torch.launch import admission_daemon as D
from repro_torch.obs import (DecisionTracer, HostHistogram, Metric,
                             MetricsServer, annotate, get_logger, log_buckets,
                             render_prometheus, snapshot_to_prometheus,
                             telemetry_summary)
from repro_torch.obs import counters as C
from repro_torch.sim import make_run
from torch_lockstep import port_config, reference_draws
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the golden configuration of tests/test_telemetry.py
CFG = SimConfig(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
                dt=24.0, max_slots=96, max_arrivals=4, d_points=8,
                priors=AZURE_PRIORS)
GRID = geometric_grid(24.0, 3 * 30 * 24.0, 12)
PGRID = np.asarray(GRID)
GOLDEN_RUNS = {   # name: (K, kind, policy, seed), as tests/test_telemetry.py
    "zeroth": (1, ZEROTH, dict(threshold=300.0), 0),
    "second_k3": (3, SECOND, dict(rho=0.05), 1),
}
TIMEOUT = 60.0


# ---------------------------------------------------------------------------
# the folds, bit for bit
# ---------------------------------------------------------------------------

def _assert_tel_equal(port, ref):
    for got, want in zip(port, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_folds_match_reference(seed):
    rng = np.random.default_rng(seed)
    a = 8
    f32 = lambda x: np.asarray(x, np.float32)
    j_tel, t_tel = JC.init_telemetry(), C.init_telemetry(device="cpu")
    for step in range(12):
        if step % 3 == 0:
            j_tel, t_tel = JC.mark_refresh(j_tel), C.mark_refresh(t_tel)
        util = f32(rng.uniform(-50.0, 600.0))      # clips at both edges
        stats = [f32(rng.gamma(2.0, 30.0)) for _ in C.WindowStats._fields]
        j_tel = JC.fold_window(j_tel, jnp.asarray(util), 500.0,
                               JC.WindowStats(*map(jnp.asarray, stats)))
        t_tel = C.fold_window(t_tel, torch.from_numpy(util), 500.0,
                              C.WindowStats(*map(torch.from_numpy, stats)))
        valid = rng.random(a) < 0.7
        accept = valid & (rng.random(a) < 0.6)
        fits = rng.random(a) < 0.8
        placed = accept & (rng.random(a) < 0.9)
        c0 = f32(1.0 + rng.poisson(4.0, a))
        j_tel = JC.fold_decisions(j_tel, *map(jnp.asarray, (
            accept, valid, fits, placed, c0)))
        t_tel = C.fold_decisions(t_tel, *map(torch.from_numpy, (
            accept, valid, fits, placed, c0)))
        _assert_tel_equal(t_tel, j_tel)
    assert telemetry_summary(t_tel) == j_telemetry_summary(j_tel)
    assert float(t_tel.n_windows) == 12.0
    with pytest.raises(ValueError, match="one run"):
        telemetry_summary(C.init_telemetry(runs=(2, 3), device="cpu"))


def test_init_telemetry_defaults_to_the_card():
    """``init_telemetry`` builds on the card unless asked for the CPU, as
    every entry point does (``device.resolve_device``)."""
    tel = C.init_telemetry(runs=(3,), device="cpu")
    assert tel.scalars.shape == (3, C.N_SCALARS)
    if torch.cuda.is_available():
        assert C.init_telemetry().scalars.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        C.init_telemetry()


def test_fleet_rider_summary_matches_reference():
    """A fleet's rider ([C]-leading leaves): totals over the clusters plus
    ``per_cluster``, with the JAX package's keys and values."""
    rng = np.random.default_rng(3)
    tel = C.TelemetryState(*(
        torch.from_numpy(rng.gamma(2.0, 3.0, (3, n)).astype(np.float32))
        for n in (C.N_SCALARS, C.N_STALENESS_BINS, C.N_OCC_BINS,
                  C.N_OCC_BINS)))
    want = j_telemetry_summary(JC.TelemetryState(*(
        jnp.asarray(x.numpy()) for x in tel)))
    got = telemetry_summary(tel)
    assert got == want and len(got["per_cluster"]["n_routed"]) == 3


# ---------------------------------------------------------------------------
# make_run's rider
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(GOLDEN_RUNS))
def golden(request):
    """A golden run in both packages with the rider on: the JAX package's
    own ``make_run``, and the port's ``make_run`` on the JAX package's
    draws."""
    k, kind, pol_kw, seed = GOLDEN_RUNS[request.param]
    cfg = CFG._replace(agg_refresh_steps=k, telemetry=True)
    j_pol = j_make_policy(kind, capacity=cfg.capacity, **pol_kw)
    j_m, j_acc, j_tel = j_make_run(cfg, GRID, kind, record_decisions=True)(
        jax.random.PRNGKey(seed), j_pol)
    theta = pol_kw.get("rho", pol_kw.get("threshold"))
    stream, events = reference_draws(cfg._replace(telemetry=False), GRID,
                                     kind, [jax.random.PRNGKey(seed)],
                                     [theta])
    run = make_run(port_config(cfg), PGRID, kind, record_decisions=True,
                   device="cpu")
    t_out = run([0], bridge.from_reference(jax.tree.map(
        np.asarray, j_pol)), stream=bridge.from_reference(stream),
        events=[bridge.from_reference(ev) for ev in events])
    return cfg, (j_m, np.asarray(j_acc), j_tel), t_out


def test_make_run_rider_matches_reference(golden):
    cfg, (j_m, j_acc, j_tel), (t_m, t_acc, t_tel) = golden
    np.testing.assert_array_equal(t_acc[0].numpy(), j_acc)
    one = C.TelemetryState(*(x[0] for x in t_tel))
    assert telemetry_summary(one) == j_telemetry_summary(j_tel)
    _assert_conservation(telemetry_summary(one), t_m, cfg)


def _assert_conservation(s, m, cfg):
    """The counting laws of tests/test_telemetry.py."""
    decided = s["n_admit"] + s["n_reject_capacity"] + s["n_reject_policy"]
    assert decided == s["n_routed"]
    assert s["n_admit"] == float(torch.sum(m.arrivals_accepted))
    assert decided == float(torch.sum(m.arrivals_accepted)
                            + torch.sum(m.arrivals_rejected))
    assert sum(s["staleness_hist"]) == s["n_routed"]
    assert s["n_windows"] == cfg.n_steps
    assert sum(s["occupancy_hist"]) == sum(s["headroom_hist"]) == cfg.n_steps
    assert s["n_refreshes"] == cfg.n_steps // cfg.agg_refresh_steps
    assert 0 < s["arr_placed"] <= s["n_admit"]
    assert s["arr_c0_mean"] > 0 and s["arr_c0_var"] >= 0


@pytest.mark.parametrize("seeds", [3, [3, 9, 27]], ids=["run", "batch"])
def test_rider_changes_no_decision_and_conserves(seeds):
    cfg = port_config(CFG._replace(agg_refresh_steps=3))
    pol = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    m_off, acc_off = make_run(cfg, PGRID, SECOND, record_decisions=True,
                              device="cpu")(seeds, pol)
    m_on, acc_on, tel = make_run(cfg._replace(telemetry=True), PGRID, SECOND,
                                 record_decisions=True, device="cpu")(
                                     seeds, pol)
    assert torch.equal(acc_on, acc_off)
    for name in m_off._fields:
        assert torch.equal(getattr(m_on, name), getattr(m_off, name)), name
    if isinstance(seeds, int):
        _assert_conservation(telemetry_summary(tel), m_on, cfg)
        return
    single = make_run(cfg._replace(telemetry=True), PGRID, SECOND,
                      device="cpu")
    for r, seed in enumerate(seeds):
        one = C.TelemetryState(*(x[r] for x in tel))
        m_r, tel_r = single(seed, pol)
        _assert_tel_equal(one, tuple(x.numpy() for x in tel_r))
        _assert_conservation(telemetry_summary(one), m_r, cfg)


# ---------------------------------------------------------------------------
# export, tracer, logger
# ---------------------------------------------------------------------------

def _snapshot(hist_cls, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    lat = hist_cls(log_buckets(0.05 / 512, 0.05, 10) + (0.1, 0.2))
    batch = hist_cls(log_buckets(1.0, 8.0, 8))
    for v in rng.gamma(2.0, 0.005, 200):
        lat.observe(float(v))
    for v in rng.integers(1, 9, 50):
        batch.observe(float(v))
    tel = {"n_admit": 47.0, "n_reject_capacity": 1.0, "n_reject_policy": 4.0,
           "n_routed": 52.0, "n_refreshes": 10.0, "n_windows": 30.0,
           "staleness_hist": [17.0, 18.0, 17.0] + [0.0] * 13,
           "occupancy_hist": [21.0, 9.0] + [0.0] * 14,
           "headroom_hist": [0.0] * 14 + [9.0, 21.0],
           "obs": {"core_deaths": 311.0, "exposure_core_hours": 16440.0,
                   "n_scaleouts": 126.0, "scaleout_cores": 190.0,
                   "alive_hours": 1824.0, "spont_deaths": 26.0,
                   "departed": 39.0},
           "arr_placed": 47.0, "arr_c0_mean": 3.957446808510638,
           "arr_c0_var": 57.91308284291535}
    eng = {"n_requests": 52, "n_flushes": 30, "n_refreshes": 10,
           "n_ticks": 30, "queue_depth": 2, "pump_idle_fraction": 0.25,
           "decision_latency_seconds": lat, "flush_batch_size": batch,
           "deadline_misses": 3, "flush_slo_ms": 50.0, "n_shards": 1}
    return {"engine": eng, "telemetry": tel}


@pytest.mark.parametrize("seed", range(3))
def test_export_matches_reference(seed):
    port, ref = _snapshot(HostHistogram, seed), _snapshot(JHostHistogram,
                                                          seed)
    assert snapshot_to_prometheus(port) == j_snapshot_to_prometheus(ref)
    assert D.snapshot_log_line(port) == j_snapshot_log_line(ref)
    for p in (0.0, 0.5, 0.99, 1.0):
        for name in ("decision_latency_seconds", "flush_batch_size"):
            assert port["engine"][name].percentile(p) == \
                ref["engine"][name].percentile(p)
    del port["telemetry"], ref["telemetry"]
    assert snapshot_to_prometheus(port) == j_snapshot_to_prometheus(ref)


def test_render_prometheus_escaping_and_types():
    h = HostHistogram((0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    text = render_prometheus([
        Metric("t_counter", "counter", "a counter",
               [({"q": 'sa"y\nhi\\'}, 3.0)]),
        Metric("t_hist", "histogram", "a histogram", [({}, h)]),
    ])
    assert r't_counter{q="sa\"y\nhi\\"} 3' in text
    assert 't_hist_bucket{le="+Inf"} 3' in text
    assert "t_hist_count 3" in text
    with pytest.raises(ValueError):
        render_prometheus([Metric("x", "summary", "bad type", [({}, 1)])])
    with pytest.raises(ValueError, match="sorted"):
        HostHistogram((1.0, 0.5))


def test_metrics_server_serves_and_404s():
    srv = MetricsServer(lambda: render_prometheus(
        [Metric("t_up", "gauge", "up", [({}, 1)])]), port=0)
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            assert resp.status == 200
            assert resp.headers["Content-Type"].startswith(
                "text/plain; version=0.0.4")
            body = resp.read().decode()
        assert "t_up 1" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/nope", timeout=10)
        assert err.value.code == 404
    finally:
        srv.close()


def test_decision_tracer_buffers_and_drains(tmp_path):
    path = tmp_path / "t.jsonl"
    with DecisionTracer(path, capacity=3) as tr:
        tr.record(step=0, score=torch.tensor(1.5), verdict=True)
        tr.record(step=1, score=np.float64(2.25), verdict=False)
        assert tr.n_recorded == 2 and tr.n_written == 0  # still buffered
        tr.record(step=2, score=0.5, verdict=torch.tensor(True))
        assert tr.n_written == 3
        tr.record(step=3, arr=torch.arange(2.0), verdict=True)
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert recs[0]["score"] == 1.5 and recs[1]["score"] == 2.25
    assert recs[3]["arr"] == [0.0, 1.0]
    assert all(isinstance(r["verdict"], bool) for r in recs)


def test_annotate_is_a_profiler_range():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("repro.engine.flush"):
            torch.ones(4).sum()
    assert "repro.engine.flush" in {e.key for e in prof.key_averages()}


def test_logger_rooted_and_level_controls(monkeypatch):
    from repro_torch.obs.log import set_level

    assert get_logger("foo.bar").name == "repro_torch.foo.bar"
    assert get_logger("repro_torch.serve").name == "repro_torch.serve"
    root = logging.getLogger("repro_torch")
    old_level = root.level
    try:
        set_level("WARNING")
        assert not get_logger("x").isEnabledFor(logging.INFO)
        set_level("DEBUG")
        assert get_logger("x").isEnabledFor(logging.DEBUG)
        monkeypatch.setenv("REPRO_LOG_LEVEL", "INFO")
        monkeypatch.setattr(root, "_repro_obs_configured", False,
                            raising=False)
        assert get_logger("y").isEnabledFor(logging.INFO)
        assert not get_logger("y").isEnabledFor(logging.DEBUG)
        with pytest.raises(ValueError):
            set_level("NOT_A_LEVEL")
    finally:
        root.setLevel(old_level)
        root._repro_obs_configured = True


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

DAEMON_ARGS = ["--capacity", "500", "--hours", "240", "--dt", "24",
               "--max-slots", "96", "--micro-batch", "4",
               "--arrival-rate", "0.08", "--param", "0.05"]


@pytest.mark.parametrize("extra", [[], ["--flush-slo-ms", "20"],
                                   ["--telemetry"]],
                         ids=["flush", "deadline", "telemetry"])
def test_build_engine_and_serve_loop(extra):
    args = D.parse_args(DAEMON_ARGS + ["--device", "cpu"] + extra)
    engine, stream, gen, param = D.build_engine(args)
    assert param == 0.05 and engine.width == 4
    assert engine.base.telemetry == ("--telemetry" in extra)
    stop = threading.Event()
    summary = D.serve_loop(engine, stream, gen, stop=stop)
    n_arr = stream.n_arrivals.numpy()
    assert summary["ticks"] == engine.ticks == engine.base.n_steps == 10
    assert summary["decisions"] == engine.decisions == int(n_arr.sum())
    m = engine.metrics()
    assert summary["admitted"] == int(m.arrivals_accepted)
    line = json.loads(D.snapshot_log_line(engine.metrics_snapshot()))
    assert line["engine"]["n_requests"] == engine.decisions
    assert ("telemetry" in line) == engine.base.telemetry
    # the same arrivals and events decide the same with flushes or deadlines
    if extra == ["--flush-slo-ms", "20"]:
        args = D.parse_args(DAEMON_ARGS + ["--device", "cpu"])
        ref, stream, gen, _ = D.build_engine(args)
        assert D.serve_loop(ref, stream, gen)["admitted"] == \
            summary["admitted"]


def test_serve_loop_stops_at_a_tick_boundary():
    args = D.parse_args(DAEMON_ARGS + ["--device", "cpu"])
    engine, stream, gen, _ = D.build_engine(args)
    stop = threading.Event()
    stop.set()
    summary = D.serve_loop(engine, stream, gen, stop=stop)
    assert summary["ticks"] == 0 and summary["decisions"] == 0


@pytest.mark.parametrize("flag", [["--fleet", "300,200", "--shards", "2"],
                                  ["--shards", "2"]])
def test_daemon_unported_flags_raise(flag, monkeypatch):
    """``--fleet`` and ``--shards`` are ported
    (``tests/test_torch_fleet_engine.py``, ``tests/test_torch_mesh.py``): a
    fleet with ``--shards`` is refused, as the JAX daemon refuses it, and
    ``--shards 2`` without two devices raises, naming the variable that
    asks for logical ones."""
    monkeypatch.delenv("REPRO_TORCH_DEVICE_COUNT", raising=False)
    args = D.parse_args(DAEMON_ARGS + ["--device", "cpu"] + flag)
    match = "fleet" if "--fleet" in flag else "REPRO_TORCH_DEVICE_COUNT"
    with pytest.raises(ValueError, match=match):
        D.build_engine(args)


def test_daemon_defaults_to_the_card():
    args = D.parse_args(DAEMON_ARGS)
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the daemon runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.build_engine(args)


def test_daemon_sigterm_graceful_with_live_metrics():
    env = dict(os.environ, PYTHONPATH="src")
    cmd = [sys.executable, "-m", "repro_torch.launch.admission_daemon",
           *DAEMON_ARGS, "--hours", "720", "--metrics-port", "0",
           "--throttle", "0.25", "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    head, port = [], None
    try:
        for line in proc.stdout:  # closes on daemon exit, so no hang
            head.append(line)
            m = re.search(r"metrics: http://127\.0\.0\.1:(\d+)/metrics", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "daemon never announced /metrics:\n" + "".join(head)
        body, deadline = "", time.time() + TIMEOUT
        while time.time() < deadline:
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5
                ).read().decode()
                if re.search(r"^repro_admission_ticks_total [1-9]", body,
                             re.M):
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            time.sleep(0.1)
        assert "repro_admission_requests_total" in body
        assert "repro_admission_admitted_total" in body  # telemetry enabled
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    full = "".join(head) + out
    assert proc.returncode == 0, full
    assert "shutting down gracefully" in full
    snap = json.loads(full.rsplit("final snapshot ", 1)[1].splitlines()[0])
    assert 1 <= snap["engine"]["n_ticks"] < 30
    assert "telemetry" in snap
