#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases, each fatal on failure (nothing is caught):

  1. card    — the card's name and power limit (nvidia-smi).
  2. build   — the moment-curve kernels from their CUDA source, for sm_90a.
  3. kernels — each kernel against its plain PyTorch version on the card,
               over D x N x ND; bitwise-equal repeat launches; times at the
               simulator's shapes beside the least time the card could take.
  4. main    — ``make_run`` at the paper's full scale (PAPER_FULL, the
               ``full`` preset's grid and refresh interval) for SECOND
               (rho 0.112) and ZEROTH (threshold 8,864), the paper's tuned
               values; the launch counters show the SECOND run went through
               both kernels (365 aggregate and 4,380 candidate launches).
  5. lockstep — a card core and a CPU core on one arrival stream and the
               same per-step events: equal decisions (up to float32 ties)
               and equal final metrics.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# operations per (row, grid point) and per (row, D-term checkpoint), counted
# from csrc/moment_curves.cu: one per arithmetic instruction or math-library
# call (log1pf, expm1f, expf, logf, division)
OPS_PER_POINT = 75
OPS_PER_CHECKPOINT = 35
TOL_EL = dict(rtol=2e-4, atol=1e-5)     # tests/test_kernels.py of the JAX
TOL_VL = dict(rtol=2e-3, atol=1e-4)     # package: its kernel tolerances
TIE_MARGIN = 1e-4
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def packed_case(d, n, nd, seed, device):
    """Packed rows of ``d`` numpy-made beliefs and the launcher grids."""
    import numpy as np
    import torch
    from repro_torch.core import AZURE_PRIORS, geometric_grid
    from repro_torch.core.belief import GammaBelief
    from repro_torch.kernels.moment_curves import ops

    rng = np.random.default_rng(seed)
    e = lambda base: torch.from_numpy(
        (base * np.exp(rng.standard_normal(d))).astype(np.float32))
    bel = GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                      lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))
    cores = torch.from_numpy((1.0 + rng.poisson(5.0, d)).astype(np.float32))
    alive = torch.from_numpy(rng.random(d) < 0.6)
    params = ops._pack(bel, cores, AZURE_PRIORS, alive=alive).to(device)
    t, idx, frac = ops._grids(geometric_grid(6.0, 78_840.0, n, device=device),
                              nd)
    return params, t, idx, frac


def event_ms(fn, reps=60, warm=10):
    """Median time of one call on the card's stream, host overhead
    included: CUDA events around each of ``reps`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def graph_ms(fn, reps=50, replays=7):
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    median replay time over ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(d, n, nd, aggregate):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM bandwidth, against operations over FP32 peak."""
    out_floats = 2 * n if aggregate else 2 * d * n
    nbytes = 4 * (16 * d + 3 * n + out_floats)
    ops = d * (n * OPS_PER_POINT + nd * OPS_PER_CHECKPOINT)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tolerance_used(got, want, tol):
    """max |got - want| / (atol + rtol |want|): 1.0 is the tolerance."""
    err = (got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
    return float(err.max())


def check_kernels():
    """Phase 3: kernels against plain versions; returns per-kernel records
    at the simulator's shapes."""
    import torch
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ref as R

    pairs = {
        "moment_curves_agg_packed": (K.moment_curves_agg_packed,
                                     R.moment_curves_agg_packed_ref),
        "moment_curves_packed": (K.moment_curves_packed,
                                 R.moment_curves_packed_ref),
    }
    worst = {name: 0.0 for name in pairs}
    for d in (1, 8, 37, 300, 8192, 8193):
        for n in (12, 48):
            for nd in (8, 24, 32):
                args = packed_case(d, n, nd, seed=d * 1000 + n * 10 + nd,
                                   device=DEVICE)
                for name, (kern, plain) in pairs.items():
                    el, vl = kern(*args, nd)
                    el2, vl2 = kern(*args, nd)
                    torch.cuda.synchronize()
                    if not (torch.equal(el, el2) and torch.equal(vl, vl2)):
                        raise AssertionError(
                            f"{name} not deterministic at D={d} N={n} "
                            f"ND={nd}")
                    want_el, want_vl = plain(*args, nd)
                    torch.testing.assert_close(el, want_el, **TOL_EL)
                    torch.testing.assert_close(vl, want_vl, **TOL_VL)
                    worst[name] = max(worst[name],
                                      tolerance_used(el, want_el, TOL_EL),
                                      tolerance_used(vl, want_vl, TOL_VL))
    log("kernels match their plain versions over 36 shapes each; largest "
        "share of the tolerance used: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))

    records = {}
    replaces = {
        "moment_curves_agg_packed":
            "src/repro/kernels/moment_curves/kernel.py:103",
        "moment_curves_packed": "src/repro/kernels/moment_curves/kernel.py:95",
    }
    shapes = {"moment_curves_agg_packed": (8192, 48, 24, True),
              "moment_curves_packed": (8, 48, 24, False)}
    for name, (kern, plain) in pairs.items():
        d, n, nd, agg = shapes[name]
        args = packed_case(d, n, nd, seed=11, device=DEVICE)
        el, vl = kern(*args, nd)
        want_el, want_vl = plain(*args, nd)
        max_abs = max(float((el - want_el).abs().max()),
                      float((vl - want_vl).abs().max()))
        b_ms, b_by = bound(d, n, nd, agg)
        rec = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/moment_curves/csrc/"
                   "moment_curves.cu",
            replaces=replaces[name], launches=0, max_abs_err=max_abs,
            ms=event_ms(lambda: kern(*args, nd)),
            plain_ms=event_ms(lambda: plain(*args, nd)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=graph_ms(lambda: kern(*args, nd)),
            shape=dict(D=d, N=n, ND=nd))
        log(f"{name} at D={d} N={n} ND={nd}: {rec['ms']:.4f} ms a call "
            f"({rec['device_ms']:.4f} ms on the device, CUDA graph), plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
            f"max abs err {max_abs:.3e}")
        records[name] = rec
    return records


def main_path(records):
    """Phase 4: make_run at PAPER_FULL for SECOND and ZEROTH."""
    import math

    import torch
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, ZEROTH, geometric_grid, make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import make_run

    # the JAX package's ``full`` benchmark preset (benchmarks/common.py):
    # refresh the aggregate every 12 steps, 48-point grid out to 3 horizons
    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 48, device=DEVICE)
    runs = [("second", SECOND, dict(rho=PAPER_TABLE2["second_rho"])),
            ("zeroth", ZEROTH,
             dict(threshold=PAPER_TABLE2["zeroth_threshold"]))]
    out = {}
    for name, kind, kw in runs:
        run = make_run(cfg, grid, kind, device=DEVICE)
        policy = make_policy(kind, capacity=cfg.capacity, **kw)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = run(2018, policy)
        util, fail = float(m.utilization), float(m.failure_rate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        log(f"PAPER_FULL {name}: utilization {util:.4f}, failure rate "
            f"{fail:.3e}, accepted {float(m.arrivals_accepted):.0f}, "
            f"rejected {float(m.arrivals_rejected):.0f}, wall {wall:.2f} s, "
            f"{cfg.n_steps / wall:.1f} steps/s, launches {launches}")
        if not (math.isfinite(util) and math.isfinite(fail)
                and 0.0 < util <= 1.0 and 0.0 <= fail <= 1.0):
            raise AssertionError(f"{name}: bad metrics {util}, {fail}")
        for field in m:
            if not bool(torch.isfinite(field).all()):
                raise AssertionError(f"{name}: non-finite metrics")
        n_refresh = cfg.n_steps // cfg.agg_refresh_steps
        want = ({"moment_curves_agg_packed": n_refresh,
                 "moment_curves_packed": cfg.n_steps} if kind == SECOND
                else {"moment_curves_agg_packed": 0,
                      "moment_curves_packed": 0})
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        out[name] = dict(utilization=util, failure_rate=fail, wall_s=wall,
                         steps_per_s=cfg.n_steps / wall)
        if kind == SECOND:
            for k, v in launches.items():
                records[k]["launches"] = v
    return out


def lockstep():
    """Phase 5: a card core against a CPU core, step by step."""
    import torch
    from repro_torch.configs import PAPER_CPU
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.sim import draw_arrival_stream, make_admission_core
    from repro_torch.sim.core import tree_to
    from repro_torch.sim.simulator import (_accumulate_step, _run_metrics,
                                           _steps)

    cfg = PAPER_CPU._replace(agg_refresh_steps=4)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 24)
    devs = ("cpu", DEVICE)
    cores = {d: make_admission_core(cfg, grid, SECOND, device=d)
             for d in devs}
    policy = make_policy(SECOND, rho=0.112, capacity=cfg.capacity)
    gen = torch.Generator().manual_seed(5)
    stream = draw_arrival_stream(gen, cfg)
    steps = {d: _steps(tree_to(stream, d)) for d in devs}
    pols = {d: tree_to(policy, d) for d in devs}
    cs = {d: cores[d].init() for d in devs}
    traces = {d: ([], []) for d in devs}
    arange = {d: torch.arange(cfg.max_arrivals, device=d) for d in devs}
    ties, agg_rel = 0, 0.0
    for t in range(cfg.n_steps):
        if t % cfg.agg_refresh_steps == 0:
            for d in devs:
                cs[d] = cores[d].refresh_aggregates(cs[d])
            want = cs["cpu"].agg_el
            rel = (cs[DEVICE].agg_el.cpu() - want).abs() / want.abs()
            agg_rel = max(agg_rel, float(torch.nan_to_num(rel).max()))
        ev = cores["cpu"].sample_events(gen, cs["cpu"].slots)
        acc, diag = {}, {}
        for d in devs:
            slots, out = cores[d].apply_step_events(cs[d].slots,
                                                    tree_to(ev, d))
            st = steps[d][t]
            valid = arange[d] < st.n_arrivals
            c, acc[d], diag[d] = cores[d].decide_batch_traced(
                pols[d], cs[d]._replace(slots=slots), out.util,
                cores[d].candidates(st), st, valid)
            n_acc = torch.sum(acc[d].float())
            n_rej = torch.sum(valid.float()) - n_acc
            slots, util_end = _accumulate_step(c.slots, out, n_acc, n_rej,
                                               cfg.dt)
            cs[d] = c._replace(slots=slots)
            traces[d][0].append(util_end)
            traces[d][1].append(out.failed)
        differ = acc["cpu"] != acc[DEVICE].cpu()
        if bool(differ.any()):
            margin = min(float(((dg.score.cpu() - dg.threshold.cpu()).abs()
                                / dg.threshold.cpu().abs())[differ].min())
                         for dg in diag.values())
            if margin >= TIE_MARGIN:
                raise AssertionError(
                    f"step {t}: decisions differ at margin {margin:.3e}")
            # a float32 tie: carry on from the CPU core's state
            ties += 1
            cs[DEVICE] = tree_to(cs["cpu"], DEVICE)
            for i in range(2):
                traces[DEVICE][i][-1] = traces["cpu"][i][-1].to(DEVICE)
    metrics = {d: _run_metrics(cfg, cs[d].slots, torch.stack(traces[d][0]),
                               torch.stack(traces[d][1])) for d in devs}
    for name in metrics["cpu"]._fields:
        torch.testing.assert_close(getattr(metrics[DEVICE], name).cpu(),
                                   getattr(metrics["cpu"], name),
                                   rtol=1e-5, atol=0.0)
    log(f"lockstep at PAPER_CPU ({cfg.n_steps} steps, {cfg.max_slots} "
        f"slots): decisions equal, {ties} float32 ties "
        f"(margin < {TIE_MARGIN}); refreshed aggregate E[L], card vs CPU, "
        f"largest relative difference {agg_rel:.3e}; utilization "
        f"{float(metrics[DEVICE].utilization):.4f} on both")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs the "
                 "port on a card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase("1. card")
    card = card_line()
    log(card)

    phase("2. build")
    from repro_torch.kernels._build import build_report
    from repro_torch.kernels.moment_curves import kernel as K

    t0 = time.perf_counter()
    K._library()
    nvcc_log, nvcc_s = build_report(K.SOURCE)
    log(f"built {K.SOURCE.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {nvcc_s:.2f} s)")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())

    phase("3. kernels against their plain versions")
    records = check_kernels()

    phase("4. main path at PAPER_FULL")
    main_path(records)

    phase("5. card against CPU, in lockstep")
    lockstep()

    log(card)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
