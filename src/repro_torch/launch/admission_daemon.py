"""The admission controller as a long-lived service gating a cluster's job
queue: the port's counterpart of the JAX package's
``launch/admission_daemon.py``, on the card by default.

Each *deployment* is an elastic model-serving/training job; its "cores" are
accelerator chips that scale out with load following the paper's
processes. The daemon is a thin loop around
``serve.admission.OnlineAdmissionEngine``: one slot table + maintained
aggregate moment curves on the device, advanced ``dt`` hours per tick, with
every arriving job submitted through the micro-batching front-end and
admitted iff the configured policy (default: the second-moment / Cantelli
condition of Corollary 1) keeps Pr(chip demand > capacity) under the SLA.

Default thresholds are the **tuned operating points** recorded in the
committed ``BENCH_quick.json`` calibration rows (rescaled to the daemon's
capacity); hand-picked constants remain only as a warned fallback when no
row exists.

Observability: ``--metrics-port`` serves the engine's non-blocking
``metrics_snapshot()`` as Prometheus text on ``GET /metrics`` (device
telemetry counters + decision-latency/batch-size histograms; port 0 binds an
ephemeral port and logs it). SIGTERM/SIGINT shut down gracefully: the serve
loop stops at the next tick boundary, pending futures are flushed, and the
final metrics snapshot is logged before exit 0.

``--flush-slo-ms L`` switches from per-tick caller-driven flushing to the
engine's deadline scheduler, which fires partial micro-batches before any
pending request exceeds its L-millisecond decision SLO (misses surface as
``repro_admission_deadline_misses_total`` on ``/metrics``). ``--fleet
C1,C2,...`` serves a routed fleet of clusters with those capacities (their
sum replaces ``--capacity``), with a ``fleet_policy`` from the operating
point: the fleet-total threshold split in proportion to capacity, rho
shared; ``/metrics`` then carries per-cluster gauges. ``--shards`` is not
ported yet (ROADMAP Queue A, item 5, the mesh) and raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.admission_daemon --hours 2000 \
      --capacity 4096 [--policy second|first|zeroth] \
      [--param RHO_OR_THRESHOLD] [--micro-batch 8] [--metrics-port 9109] \
      [--throttle 0.05] [--flush-slo-ms 50] [--fleet 8000,6000,4000,2000] \
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import signal
import threading
import time

import numpy as np
import torch

from ..core import (FIRST, SECOND, ZEROTH, fleet_policy, geometric_grid,
                    make_policy)
from ..obs import get_logger, set_level

log = get_logger("launch.admission_daemon")  # stable name under python -m

#: chips per replica of each servable arch (model-parallel footprint at bf16)
CHIPS_PER_REPLICA = {
    "hymba-1.5b": 1, "llama3.2-1b": 1, "xlstm-125m": 1, "whisper-small": 1,
    "starcoder2-3b": 1, "qwen3-14b": 4, "granite-20b": 4,
    "chameleon-34b": 8, "moonshot-v1-16b-a3b": 8, "dbrx-132b": 32,
}

POLICY_KINDS = {"zeroth": ZEROTH, "first": FIRST, "second": SECOND}

_NOT_PORTED = "is not ported yet: ROADMAP.md, Queue A, item 5 ({})"


def build_engine(args):
    """CLI args -> (engine, stream, gen, param): the configured online
    engine, the synthetic arrival stream driving it, the generator its ticks
    draw the events from (seeded ``--seed``, as ``make_run``'s), and the
    policy parameter."""
    from ..serve import OnlineAdmissionEngine, default_policy_param
    from ..sim import (FleetConfig, draw_arrival_stream, make_config,
                       stream_config)

    if getattr(args, "shards", None) not in (None, 1):
        raise NotImplementedError("--shards " + _NOT_PORTED.format("mesh"))
    kind_name = args.policy
    kind = POLICY_KINDS[kind_name]
    telemetry = bool(getattr(args, "telemetry", False)
                     or getattr(args, "metrics_port", None) is not None)
    base = make_config(capacity=args.capacity, arrival_rate=args.arrival_rate,
                       horizon_hours=args.hours, dt=args.dt,
                       max_slots=args.max_slots, max_arrivals=args.micro_batch,
                       telemetry=telemetry)
    grid = geometric_grid(args.dt, args.hours * 3, 32)

    param = args.param
    if param is None:
        param = default_policy_param(kind_name, args.capacity,
                                     scale_name=args.scale)
    if getattr(args, "fleet", None):
        caps = tuple(float(c) for c in args.fleet.split(","))
        if abs(sum(caps) - args.capacity) > 1e-6:
            base = base._replace(capacity=float(sum(caps)))
        cfg = FleetConfig(base=base, capacities=caps)
        pol = fleet_policy(kind, capacities=caps, threshold=param, rho=param)
    else:
        cfg = base
        pol = make_policy(kind, threshold=param, rho=param,
                          capacity=base.capacity)
    engine = OnlineAdmissionEngine(cfg, grid, kind, pol,
                                   micro_batch=args.micro_batch,
                                   scale=args.scale,
                                   flush_slo_ms=getattr(args, "flush_slo_ms",
                                                        None),
                                   seed=args.seed, device=args.device)
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    stream = draw_arrival_stream(gen, stream_config(cfg))
    return engine, stream, gen, param


def serve_loop(engine, stream, gen, *, log_every: int = 0,
               stop: threading.Event | None = None,
               throttle_s: float = 0.0) -> dict:
    """Drive the engine tick by tick: dynamics (drawn with ``gen``), then
    this window's arrivals through the micro-batching submit/flush
    front-end. Returns summary counters (the engine itself holds the
    metrics).

    ``stop`` (checked at each tick boundary) ends the loop early — the
    graceful-shutdown path; pending futures are still flushed and resolved.
    ``throttle_s`` sleeps between ticks so a scraper can watch ``/metrics``
    evolve.

    With a flush SLO configured on the engine, the deadline scheduler owns
    flushing: the loop only submits and awaits futures (resolved by the
    scheduler thread within the SLO); otherwise it drives the
    caller-flushed protocol, one full flush per tick."""
    from ..bridge import to_numpy
    from ..serve import Arrival

    slo_mode = engine.flush_slo_s is not None
    if slo_mode:
        engine.start()
    host = to_numpy(stream)      # tickets are numpy: one copy, not one a lane
    n_steps = engine.base.n_steps
    max_a = int(host.c0.shape[1])
    admitted = 0
    t0 = time.time()
    ticks = 0
    for t in range(n_steps):
        if stop is not None and stop.is_set():
            log.info("stop requested at tick %d/%d", t, n_steps)
            break
        engine.tick(gen=gen)
        ticks += 1
        futs = [engine.submit(Arrival.from_stream(host, t, a))
                for a in range(min(int(host.n_arrivals[t]), max_a))]
        if not slo_mode:
            engine.flush()
        admitted += sum(f.result() for f in futs)
        if log_every and (t + 1) % log_every == 0:
            m = engine.metrics()
            log.info("t=%d/%d util=%.3f admitted=%d/%d", t + 1, n_steps,
                     float(m.utilization), admitted, engine.decisions)
        if throttle_s > 0.0:
            time.sleep(throttle_s)
    if slo_mode:
        engine.stop()      # joins the scheduler; final drain inside
    elif ticks:
        engine.flush()     # resolve anything a racing submitter queued
    return {"admitted": admitted, "decisions": engine.decisions,
            "ticks": ticks, "seconds": time.time() - t0}


def snapshot_log_line(snap: dict) -> str:
    """One JSON line of the scalar snapshot fields (histograms reduced to
    p50/p99 and counts) — what the daemon logs at shutdown."""
    eng = dict(snap.get("engine", {}))
    lat = eng.pop("decision_latency_seconds", None)
    batch = eng.pop("flush_batch_size", None)
    if lat is not None:
        eng["latency_p50_s"] = round(lat.percentile(0.5), 6)
        eng["latency_p99_s"] = round(lat.percentile(0.99), 6)
    if batch is not None:
        eng["mean_batch"] = round(batch.sum / max(batch.total, 1), 3)
    out = {"engine": eng}
    tel = snap.get("telemetry")
    if tel:
        out["telemetry"] = {k: v for k, v in tel.items()
                            if isinstance(v, (int, float))}
        out["telemetry"]["obs_departed"] = tel["obs"]["departed"]
    return json.dumps(out, sort_keys=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=float, default=4096.0)
    ap.add_argument("--hours", type=float, default=2000.0)
    ap.add_argument("--dt", type=float, default=6.0)
    ap.add_argument("--arrival-rate", type=float, default=0.2)
    ap.add_argument("--max-slots", type=int, default=512)
    ap.add_argument("--micro-batch", type=int, default=8)
    ap.add_argument("--policy", default="second", choices=POLICY_KINDS)
    ap.add_argument("--param", type=float, default=None,
                    help="threshold (zeroth/first, chips) or rho (second); "
                         "default: tuned operating point from BENCH_<scale>")
    ap.add_argument("--fleet", default=None, metavar="C1,C2,...",
                    help="serve a fleet of clusters with these capacities "
                         "(overrides --capacity with their sum)")
    ap.add_argument("--scale", default="quick",
                    help="BENCH_<scale>.json supplying tuned operating "
                         "points and the measured agg-refresh K-curve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text on GET /metrics at this "
                         "port (0 = ephemeral; enables device telemetry)")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry the device telemetry rider even without a "
                         "metrics port")
    ap.add_argument("--throttle", type=float, default=0.0, metavar="SECONDS",
                    help="sleep between ticks so /metrics can be watched "
                         "while the daemon runs")
    ap.add_argument("--shards", type=int, default=None, metavar="N",
                    help="shard the slot table over N devices (not ported "
                         "yet: ROADMAP Queue A, item 5)")
    ap.add_argument("--flush-slo-ms", type=float, default=None, metavar="MS",
                    help="decision-latency SLO: run the deadline-aware "
                         "flush scheduler instead of per-tick flushing")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (cuda, or cpu for the plain "
                         "PyTorch lanes)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    set_level("INFO")  # the daemon is a CLI: its operational log is output

    engine, stream, gen, param = build_engine(args)
    mode = f"fleet[{args.fleet}]" if args.fleet else "single"
    log.info("policy=%s param=%g capacity=%.0f chips %s micro_batch=%d "
             "agg_refresh_K=%d telemetry=%s shards=%d flush_slo_ms=%s "
             "device=%s", args.policy, param, args.capacity, mode,
             engine.width,
             engine.k_refresh, engine.base.telemetry, engine.n_shards,
             args.flush_slo_ms, engine.device)
    names = tuple(CHIPS_PER_REPLICA)
    rng = np.random.default_rng(args.seed)
    log.info("sample of admitted job types: %s",
             [names[i] for i in rng.choice(len(names), size=8)])
    log.info("chips/replica table: %s", CHIPS_PER_REPLICA)

    server = None
    if args.metrics_port is not None:
        from ..obs import MetricsServer, snapshot_to_prometheus
        server = MetricsServer(
            lambda: snapshot_to_prometheus(engine.metrics_snapshot()),
            port=args.metrics_port)
        log.info("metrics: http://127.0.0.1:%d/metrics", server.port)

    stop = threading.Event()

    def _on_signal(signum, frame):
        log.info("received %s; shutting down gracefully",
                 signal.Signals(signum).name)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    try:
        summary = serve_loop(engine, stream, gen, log_every=args.log_every,
                             stop=stop, throttle_s=args.throttle)
        m = engine.metrics()
        rate = summary["decisions"] / max(summary["seconds"], 1e-9)
        log.info("utilization=%.3f scaleout_failures=%d/%d admitted=%d "
                 "rejected=%d", float(m.utilization), int(m.failed_requests),
                 int(m.total_requests), int(m.arrivals_accepted),
                 int(m.arrivals_rejected))
        log.info("served %d admission decisions over %d ticks in %.1fs "
                 "(%.1f decisions/s)", summary["decisions"],
                 summary["ticks"], summary["seconds"], rate)
        log.info("final snapshot %s",
                 snapshot_log_line(engine.metrics_snapshot()))
    finally:
        if server is not None:
            server.close()


if __name__ == "__main__":
    main()
