"""Online admission serving rows: decisions/s and decision latency, live.

Measures ``serve.admission.OnlineAdmissionEngine`` (the long-lived engine
with the maintained aggregate and a micro-batching front-end) against the
naive lane (a full aggregate recompute and a width-1 decision a request,
i.e. admission without the incrementally maintained aggregate):

  * ``serve/<scale>/engine`` / ``serve/<scale>/naive`` — decisions/s and
    p50/p99 latency of a decision call at the reference offered load, with
    the occupied-slot count (the cluster state's size).
  * ``serve/<scale>/speedup`` — the micro-batched over the naive rate.
  * ``serve/<scale>/telemetry=on|off`` — the per-decision p50 with the
    telemetry rider on and off, two engines in lockstep.
  * ``serve/<scale>/load=<n>`` — the engine's rate against the offered
    load (arrivals a ``dt`` window), light and heavy.
  * ``serve/<scale>/engine|naive/slots=<q>`` — the same at a quarter of
    the preset's slot table: the naive lane's cost a decision scales with
    the table, the micro-batched lane's does not.
  * ``serve/<scale>/sharded`` — the engine with its slot table sharded over
    8 devices (logical ones, ``REPRO_TORCH_DEVICE_COUNT``, where the host
    has fewer), the fused aggregate lane the sharded refresh mirrors.
  * ``serve/<scale>/deadline_flush`` — the SLO-aware flush scheduler under
    paced sub-width load: p50/p99 submit-to-decision latency from the
    engine's own histogram, and its deadline-miss counter.
  * ``serve/<scale>/operating_point/<kind>`` — the tuned (theta, capacity,
    tau) operating points republished from the BENCH file's own
    ``tuning/calibrate/<kind>`` rows; ``serve.load_operating_point`` (the
    daemon's default thresholds) reads these rows.

``scale_name="smoke"`` selects a seconds-scale preset (the JAX package's
``REPRO_SMOKE=1`` preset). The arrivals and events are drawn by
``torch.Generator``s on the engine's device (the JAX package draws from
PRNG keys), so the two packages decide other requests.

PyTorch counterpart of the JAX package's ``benchmarks/serve_bench.py``, on
``device`` (the card unless the caller passes ``"cpu"``):

    python -m repro_torch.benchmarks.run --scale quick --only serve
"""
from __future__ import annotations

import json
import os
import re
import time

import numpy as np
import torch

from ..bridge import to_numpy
from ..core import SECOND, make_policy
from ..device import DEVICE_COUNT_VAR, resolve_device
from ..serve import (Arrival, OnlineAdmissionEngine, format_operating_derived,
                     operating_row_name)
from ..sim import draw_arrival_stream
from ..sim.simulator import _steps
from .common import csv_row, grid_for, scale_for, sim_config

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

_THETA_RE = re.compile(r"theta=(?P<th>[-\d.e+]+)")

#: rho when the BENCH file has no tuned second-moment row yet
FALLBACK_RHO = 0.15


def _calibrated_thetas(scale_name: str) -> dict:
    """theta per policy kind from the BENCH file's own
    ``tuning/calibrate/<kind>`` rows (no simulation here): the file
    ``$REPRO_BENCH_JSON`` names, else ``BENCH_<scale>.json`` at the repo
    root (the JAX package's)."""
    path = os.environ.get("REPRO_BENCH_JSON") or os.path.join(
        _REPO_ROOT, f"BENCH_{scale_name}.json")
    try:
        with open(path, encoding="utf-8") as f:
            rows = json.load(f).get("rows", [])
    except (OSError, ValueError):
        return {}
    out = {}
    for row in rows:
        name = row.get("name", "")
        if not name.startswith("tuning/calibrate/"):
            continue
        m = _THETA_RE.match(row.get("derived", ""))
        if m:
            out[name.rsplit("/", 1)[1]] = float(m["th"])
    return out


def _offered_stream(cfg, width: int, n_slices: int, seed: int, device):
    """``n_slices`` saturated width-``width`` arrival slices on ``device``
    (the offered load: the arrival rate pushed so high that every lane
    holds an arrival)."""
    stream_cfg = cfg._replace(max_arrivals=width,
                              horizon_hours=n_slices * cfg.dt,
                              arrival_rate=10.0 * width / cfg.dt,
                              agg_refresh_steps=1)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    return _steps(draw_arrival_stream(gen, stream_cfg))


def _measure(cfg, grid, pol, *, naive: bool, width: int, n_ticks: int,
             per_tick: int, seed: int, device, shards=None) -> dict:
    """Drive the engine ``n_ticks`` windows at ``per_tick`` offered arrivals
    each, timing every decision call (a micro-batch of ``width``, or width
    1 on the naive lane; each ends in the accept mask's copy to the host).
    Returns decisions/s, latency quantiles and the occupied slots."""
    device = resolve_device(device)
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, pol, naive=naive,
                                micro_batch=width, shards=shards,
                                device=device)
    bw = 1 if naive else width
    batches_per_tick = max(per_tick // bw, 1)
    slices = _offered_stream(cfg, bw, (n_ticks + 1) * batches_per_tick, seed,
                             device)
    valid = np.ones(bw, bool)
    gen = torch.Generator(device=device).manual_seed(seed)

    # a warm-up window outside the timed region (a decision ends in its
    # accept mask's copy to the host, which waits for the device)
    eng.tick(gen=gen)
    eng.decide_slice(slices[0], valid)

    it = iter(slices[1:])
    lat = []
    for _ in range(n_ticks):
        eng.tick(gen=gen)
        for _ in range(batches_per_tick):
            sl = next(it)
            t0 = time.perf_counter()
            eng.decide_slice(sl, valid)
            lat.append(time.perf_counter() - t0)
    lat_s = np.asarray(lat)
    n_dec = lat_s.size * bw
    return {
        "decisions_per_s": n_dec / float(np.sum(lat_s)),
        "p50_ms": float(np.percentile(lat_s, 50) * 1e3),
        "p99_ms": float(np.percentile(lat_s, 99) * 1e3),
        "us_per_decision": float(np.sum(lat_s)) * 1e6 / n_dec,
        "occupied": int(eng.core.gather_slots(eng._cs.slots).alive.sum()),
        "n_decisions": int(n_dec),
    }


def _measure_telemetry_pair(cfg, grid, pol, *, width: int, n_ticks: int,
                            per_tick: int, seed: int,
                            device) -> tuple[float, float]:
    """Per-decision p50 microseconds with the telemetry rider off and on.

    The two engines are driven in lockstep over the same events (two
    generators of one seed) and the same arrival slices, with the timing
    order alternating a batch, so that clock drift and allocator noise hit
    both sides alike. Medians, not means: the question is the steady-state
    decision path, not stray tail events.
    """
    device = resolve_device(device)
    engines = [
        OnlineAdmissionEngine(cfg._replace(telemetry=tel), grid, SECOND, pol,
                              naive=False, micro_batch=width, device=device)
        for tel in (False, True)]
    gens = [torch.Generator(device=device).manual_seed(seed)
            for _ in engines]
    batches_per_tick = max(per_tick // width, 1)
    slices = _offered_stream(cfg, width, (n_ticks + 1) * batches_per_tick,
                             seed, device)
    valid = np.ones(width, bool)
    for eng, gen in zip(engines, gens):   # warm-up outside the timed region
        eng.tick(gen=gen)
        eng.decide_slice(slices[0], valid)
    lat = [[], []]
    it = iter(slices[1:])
    for t in range(n_ticks):
        for eng, gen in zip(engines, gens):
            eng.tick(gen=gen)
        for b in range(batches_per_tick):
            sl = next(it)
            order = (0, 1) if (t * batches_per_tick + b) % 2 == 0 else (1, 0)
            for i in order:
                t0 = time.perf_counter()
                engines[i].decide_slice(sl, valid)
                lat[i].append(time.perf_counter() - t0)
    return tuple(float(np.median(lat[i]) * 1e6 / width) for i in (0, 1))


def _sharded_entry(scale_name: str, seed: int, width: int, n_ticks: int,
                   per_tick: int, shards: int, device) -> dict:
    """The sharded row's measurement: the preset's config (with the fused
    aggregate lane, which the sharded refresh mirrors) through ``_measure``
    with the slot table over ``shards`` devices."""
    scale = scale_for(scale_name)
    cfg = sim_config(scale)._replace(agg_backend="fused")
    grid = grid_for(scale, cfg)
    rho = _calibrated_thetas(scale.name).get("second", FALLBACK_RHO)
    pol = make_policy(SECOND, rho=rho, capacity=cfg.capacity)
    return _measure(cfg, grid, pol, naive=False, width=width,
                    n_ticks=n_ticks, per_tick=per_tick, seed=seed,
                    device=device, shards=shards)


def _measure_sharded(scale_name: str, *, seed: int, width: int, n_ticks: int,
                     per_tick: int, shards: int = 8, device="cuda") -> dict:
    """``_sharded_entry`` with ``REPRO_TORCH_DEVICE_COUNT`` set to
    ``shards`` for its duration and restored afterwards: ``shards``
    devices, logical ones where the host has fewer. (The JAX driver needs a
    subprocess, since XLA fixes its device count at start-up; the port
    reads the variable at each call.)"""
    old = os.environ.get(DEVICE_COUNT_VAR)
    os.environ[DEVICE_COUNT_VAR] = str(shards)
    try:
        return _sharded_entry(scale_name, seed=seed, width=width,
                              n_ticks=n_ticks, per_tick=per_tick,
                              shards=shards, device=device)
    finally:
        if old is None:
            del os.environ[DEVICE_COUNT_VAR]
        else:
            os.environ[DEVICE_COUNT_VAR] = old


def _measure_deadline(cfg, grid, pol, *, width: int, slo_ms: float,
                      n_requests: int, seed: int, device) -> dict:
    """Drive the deadline scheduler at nominal load: paced sub-width
    ``submit()``s (so that the deadline trigger, not the width trigger,
    fires), measured by the engine's own submit-to-decision latency
    histogram. Misses are the engine's counter, not a recomputation."""
    device = resolve_device(device)
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, pol, micro_batch=width,
                                flush_slo_ms=slo_ms, device=device)
    stream_cfg = cfg._replace(max_arrivals=1,
                              horizon_hours=(n_requests + 1) * cfg.dt,
                              arrival_rate=10.0 / cfg.dt,
                              agg_refresh_steps=1)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    stream = to_numpy(draw_arrival_stream(gen, stream_cfg))
    arrivals = [Arrival.from_stream(stream, t, 0)
                for t in range(n_requests + 1)]
    eng.tick(gen=torch.Generator(device=device).manual_seed(seed))
    # the decide path's first call outside the recorded region (_decide
    # touches neither the latency histogram nor the miss counter)
    eng._decide([arrivals[0]])
    pace_s = (slo_ms / 1e3) / (2.0 * width)   # nominal: sub-width an SLO
    eng.start()
    futs = []
    for a in arrivals[1:]:
        futs.append(eng.submit(a))
        time.sleep(pace_s)
    for f in futs:
        f.result(timeout=60)
    eng.stop()
    snap = eng.metrics_snapshot()["engine"]
    hist = snap["decision_latency_seconds"]
    return {
        "p50_ms": hist.percentile(0.5) * 1e3,
        "p99_ms": hist.percentile(0.99) * 1e3,
        "mean_us": hist.sum / max(hist.total, 1) * 1e6,
        "misses": int(snap["deadline_misses"]),
        "n_flushes": int(snap["n_flushes"]),
        "n_decisions": int(hist.total),
    }


def _derived(m: dict, width: int, slots: int) -> str:
    return (f"decisions_per_s={m['decisions_per_s']:.0f}"
            f" p50_ms={m['p50_ms']:.3f} p99_ms={m['p99_ms']:.3f}"
            f" occupied={m['occupied']} width={width} slots={slots}"
            f" n={m['n_decisions']}")


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    scale = scale_for(scale_name)
    smoke = scale.name == "smoke"
    width = 4 if smoke else 16
    n_ticks = 3 if smoke else 8
    per_tick = 4 * width                  # the reference offered load
    cfg = sim_config(scale)
    grid = grid_for(scale, cfg)
    thetas = _calibrated_thetas(scale.name)
    rho = thetas.get("second", FALLBACK_RHO)
    pol = make_policy(SECOND, rho=rho, capacity=cfg.capacity)
    common = dict(seed=seed, device=device)
    rows = []

    # -- the micro-batched engine against the naive lane --------------------
    m_eng = _measure(cfg, grid, pol, naive=False, width=width,
                     n_ticks=n_ticks, per_tick=per_tick, **common)
    rows.append(csv_row(f"serve/{scale.name}/engine", m_eng["us_per_decision"],
                        _derived(m_eng, width, cfg.max_slots)))
    m_nv = _measure(cfg, grid, pol, naive=True, width=width,
                    n_ticks=n_ticks, per_tick=per_tick, **common)
    rows.append(csv_row(f"serve/{scale.name}/naive", m_nv["us_per_decision"],
                        _derived(m_nv, 1, cfg.max_slots)))
    speedup = m_eng["decisions_per_s"] / m_nv["decisions_per_s"]
    rows.append(csv_row(f"serve/{scale.name}/speedup", 0.0,
                        f"x={speedup:.2f}"
                        f" engine={m_eng['decisions_per_s']:.0f}"
                        f" naive={m_nv['decisions_per_s']:.0f}"
                        f" target_x=2"))

    # -- the telemetry rider's cost -----------------------------------------
    us_off, us_on = _measure_telemetry_pair(cfg, grid, pol, width=width,
                                            n_ticks=2 * n_ticks,
                                            per_tick=per_tick, **common)
    overhead = (us_on / us_off - 1.0) * 100
    rows.append(csv_row(
        f"serve/{scale.name}/telemetry=on", us_on,
        f"p50_us={us_on:.1f} width={width} slots={cfg.max_slots}"
        f" overhead_pct={overhead:.1f} target_pct=3"))
    rows.append(csv_row(
        f"serve/{scale.name}/telemetry=off", us_off,
        "overhead_pct=0.0 rider_compiled_out=true"))

    # -- throughput against offered load ------------------------------------
    for mult in (1, 16):
        m = _measure(cfg, grid, pol, naive=False, width=width,
                     n_ticks=n_ticks, per_tick=mult * width, **common)
        rows.append(csv_row(
            f"serve/{scale.name}/load={mult * width}",
            m["us_per_decision"], _derived(m, width, cfg.max_slots)))

    # -- cluster state size: a quarter of the slot table --------------------
    small = cfg._replace(max_slots=max(cfg.max_slots // 4, width))
    for naive, tag in ((False, "engine"), (True, "naive")):
        m = _measure(small, grid, pol, naive=naive, width=width,
                     n_ticks=n_ticks, per_tick=per_tick, **common)
        rows.append(csv_row(
            f"serve/{scale.name}/{tag}/slots={small.max_slots}",
            m["us_per_decision"],
            _derived(m, 1 if naive else width, small.max_slots)))

    # -- the slot table sharded over 8 devices --------------------------------
    m_sh = _measure_sharded(scale.name, seed=seed, width=width,
                            n_ticks=n_ticks, per_tick=per_tick, shards=8,
                            device=device)
    rows.append(csv_row(
        f"serve/{scale.name}/sharded", m_sh["us_per_decision"],
        _derived(m_sh, width, cfg.max_slots) + " shards=8"))

    # -- the deadline-aware flush scheduler at nominal load -----------------
    slo_ms = 200.0 if smoke else 250.0
    m_dl = _measure_deadline(cfg, grid, pol, width=width, slo_ms=slo_ms,
                             n_requests=6 * width, **common)
    rows.append(csv_row(
        f"serve/{scale.name}/deadline_flush", m_dl["mean_us"],
        f"p50_ms={m_dl['p50_ms']:.3f} p99_ms={m_dl['p99_ms']:.3f}"
        f" slo_ms={slo_ms:.0f} misses={m_dl['misses']}"
        f" n_flushes={m_dl['n_flushes']} n={m_dl['n_decisions']}"
        f" target_misses=0"))

    # -- tuned operating points for the daemon ------------------------------
    for kind_name, theta in sorted(thetas.items()):
        rows.append(csv_row(
            operating_row_name(scale.name, kind_name), 0.0,
            format_operating_derived(theta, cfg.capacity, scale.tau)))
    return rows


if __name__ == "__main__":
    for r in run():
        print(r)
