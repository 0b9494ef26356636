"""Telemetry dashboard: what the admission controller sees about itself.

Drives the online ``OnlineAdmissionEngine`` with the device telemetry rider
on (``SimConfig(telemetry=True)``) and a ``DecisionTracer`` attached,
serves its live ``/metrics`` endpoint on an ephemeral localhost port,
scrapes it mid-run as Prometheus would, and finally renders the device-side
counters (admissions by reason, the occupancy histogram, the aggregate's
staleness at decision time) as an ASCII dashboard beside the host-side
latency percentiles and a few structured decision records.

    python -m repro_torch.examples.telemetry_dashboard [--smoke] \
        [--device cpu]

The port's counterpart of the JAX package's
``examples/telemetry_dashboard.py``, on ``--device`` (the card by
default). The decision trace goes to a temporary directory that is removed
at the end.
"""
from __future__ import annotations

import json
import os
import tempfile
import urllib.request

import torch

from ..bridge import to_numpy
from ..core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from ..obs import DecisionTracer, MetricsServer, snapshot_to_prometheus
from ..serve import Arrival, OnlineAdmissionEngine
from ..sim import SimConfig, draw_arrival_stream, split_seeds
from . import parse_args


def bar(count, total, width=32):
    n = int(round(width * count / total)) if total else 0
    return "#" * n + "." * (width - n)


def main(argv=None):
    args = parse_args(__doc__, argv)
    days = 10 if args.smoke else 90
    cfg = SimConfig(capacity=500.0, arrival_rate=0.1,
                    horizon_hours=days * 24.0, dt=24.0, max_slots=96,
                    max_arrivals=4, priors=AZURE_PRIORS,
                    agg_refresh_steps=2, telemetry=True)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 16)
    pol = make_policy(SECOND, rho=0.1, capacity=cfg.capacity)

    with tempfile.TemporaryDirectory(prefix="repro_obs_") as tmp:
        trace_path = os.path.join(tmp, "decisions.jsonl")
        tracer = DecisionTracer(trace_path)
        engine = OnlineAdmissionEngine(cfg, grid, SECOND, pol, tracer=tracer,
                                       device=args.device)
        server = MetricsServer(
            lambda: snapshot_to_prometheus(engine.metrics_snapshot()),
            port=0)
        url = f"http://127.0.0.1:{server.port}/metrics"
        print(f"live metrics at {url}")
        try:
            stream_gen, tick_gen = (
                torch.Generator(device=engine.device).manual_seed(s)
                for s in split_seeds(0, 2))
            stream = to_numpy(draw_arrival_stream(stream_gen, cfg))
            n_lanes = stream.c0.shape[1]
            for t in range(cfg.n_steps):
                engine.tick(gen=tick_gen)
                futs = [engine.submit(Arrival.from_stream(stream, t, a))
                        for a in range(min(int(stream.n_arrivals[t]),
                                           n_lanes))]
                engine.flush()
                for f in futs:
                    f.result()
                if t == cfg.n_steps // 2:   # a mid-run Prometheus scrape
                    body = urllib.request.urlopen(
                        url, timeout=10).read().decode()
                    wanted = ("repro_admission_requests_total",
                              "repro_admission_admitted_total",
                              "repro_admission_ticks_total")
                    print(f"\n-- mid-run scrape (t={t}) " + "-" * 28)
                    for line in body.splitlines():
                        if line.split("{")[0].split(" ")[0] in wanted:
                            print("  " + line)
            snap = engine.metrics_snapshot()
        finally:
            tracer.close()
            server.close()
        with open(trace_path, encoding="utf-8") as f:
            records = [json.loads(line) for line in f]

    eng, tel = snap["engine"], snap["telemetry"]
    print("\n== decisions " + "=" * 35)
    for label, n in (("admitted", tel["n_admit"]),
                     ("rejected (capacity)", tel["n_reject_capacity"]),
                     ("rejected (policy)", tel["n_reject_policy"])):
        print(f"  {label:<22} {int(n):>5}  {bar(n, tel['n_routed'])}")

    print("\n== occupancy (fraction of capacity, per window) ==")
    occ = tel["occupancy_hist"]
    for i, n in enumerate(occ):
        if n:
            lo, hi = i / len(occ), (i + 1) / len(occ)
            print(f"  [{lo:4.2f},{hi:4.2f}) {int(n):>4}  {bar(n, sum(occ))}")

    print("\n== aggregate staleness at decision time (windows) ==")
    for i, n in enumerate(tel["staleness_hist"]):
        if n:
            print(f"  {i:>2} stale {int(n):>5}  "
                  f"{bar(n, sum(tel['staleness_hist']))}")

    lat = eng["decision_latency_seconds"]
    print("\n== engine ==")
    print(f"  requests={eng['n_requests']} flushes={eng['n_flushes']} "
          f"refreshes={eng['n_refreshes']} ticks={eng['n_ticks']}")
    print(f"  decision latency p50={lat.percentile(0.5) * 1e3:.2f}ms "
          f"p99={lat.percentile(0.99) * 1e3:.2f}ms")
    print(f"  observed departures={tel['obs']['departed']:.0f} "
          f"scale-outs={tel['obs']['n_scaleouts']:.0f}")

    print(f"\n== decision trace ({len(records)} records) ==")
    for rec in records[:3]:
        print("  " + json.dumps(rec))
    if len(records) != eng["n_requests"]:
        raise RuntimeError(f"{len(records)} trace records for "
                           f"{eng['n_requests']} requests")


if __name__ == "__main__":
    main()
