#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases, each fatal on failure (nothing is caught), each printing its wall
time:

  1. card    — the card's name and power limit (nvidia-smi).
  2. build   — one nvcc per CUDA source, all started together, for sm_90a;
               this phase waits for the moment-curve kernels.
  3. kernels — both moment-curve kernels in both forms (belief columns in,
               the main path's; packed rows, the TPU kernel's interface)
               against their plain PyTorch versions on the card, over
               D x N x ND; bitwise-equal repeat launches; the aggregate's
               registers and CTAs an SM; an empty kernel in a CUDA graph
               (the launch floor); times at the simulator's shapes beside
               the least time the card could take, and a call of each
               ``ops`` entry point against the packed path it replaced
               (pack + grids + packed launch).
               Then the batched aggregate (R runs' slot tables in one
               launch) for R x D x N = {1, 3, 24, 240} x {96, 8,192, 8,193,
               20,000} x {12, 48}: against its plain version, bit for bit
               run by run against one-run launches, one CUDA kernel a call
               (counted from a CUDA graph of it), its times at R = 24 and
               240 (D = 8,192, N = 48) beside the bound for R runs and
               beside R one-run launches in one CUDA graph.
  4. main    — ``make_run`` at the paper's full scale (PAPER_FULL, the
               ``full`` preset's grid and refresh interval) for SECOND
               (rho 0.112) and ZEROTH (threshold 8,864), the paper's tuned
               values; the launch counters show the SECOND run went through
               both belief-form kernels (365 aggregate and 4,380 candidate
               launches) and no packed one.
  4b. batch  — the same SECOND run as one batch of 24 seeds, 2018 among
               them: 4,380 candidate launches (each the batch's 24 x 8
               rows) and 365 aggregate launches for the whole batch (each
               over all 24 runs); run 2018 equal to phase 4's bit for bit;
               runs x steps/s beside phase 4's steps/s.
  4c. Table 2 — ``repro_torch.benchmarks.common.tune_and_eval`` at the
               ``quick`` preset for ZEROTH, FIRST and SECOND: theta,
               utilization with its BCa interval, SLA rate, stages,
               simulations and seconds, beside the JAX package's
               ``tuning/calibrate/*`` rows of BENCH_quick.json; every chosen
               theta feasible under the port's own measurement.
  5. lockstep — a card core and a CPU core on one arrival stream and the
               same per-step events: equal decisions (up to float32 ties)
               and equal final metrics; the refreshed aggregate's largest
               relative gap, card against CPU.
  6. build   — the two attention kernels (flash attention, GQA decode):
               nvcc's register, spill, shared-memory and warning lines.
  7. attention kernels — each against its plain PyTorch version (flash:
               B x S x heads x dtype x window, float32 at 2e-5 and bf16
               within one bf16 ulp; decode: B x S x lengths x dtypes, float32
               output at 3e-5 for either cache), bitwise-equal repeats; bf16
               flash keeps p in float32: its outputs equal the rounded
               float32 result where a version rounding p to bf16 does not;
               bf16 flash at sequence lengths around its tiles for G = 1, 4
               and 8, on fused-QKV views (equal bits to contiguous copies),
               and refusing a misaligned view; decode (one cluster launch a
               call) at lengths around its key tile and split share for
               G = 1-16, Dh = 64/128/256, every q/cache dtype pairing,
               refusing a misaligned view, and one CUDA kernel a call
               (counted from a CUDA graph of it); times at llama3.2-1b's
               shapes (and flash at Dh = 128) beside the bound and SDPA,
               each also in a CUDA graph, and decode also cold (a graph
               over 6 caches in turn, 100 MB of valid K/V).
  8. LM forward — llama3.2-1b at full width (16 layers, bf16 activations,
               weights from the port's seeded init) with the flash lane on
               (16 kernel launches a forward) and off: logits agree at the
               bf16 tolerance; tokens/s of both lanes; a profile of the
               flash lane.
  9. decode layer — layer 0's attention with the decode kernel lane against
               the einsum lane: 64 positions from a bf16 cache of 4,096
               slots holding 2,048, B = 4; outputs agree at every step.
 10. server  — ``repro_torch.launch.serve`` at its defaults (llama3.2-1b,
               12 requests, 16 new tokens, batch 4, 256 slots): every
               request answered, tokens/s, fused and loop prefill give equal
               tokens; then the engine on the card against the engine on the
               CPU at full width, 2 layers, float32: equal tokens up to
               counted float32 ties.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12     # dense bf16 tensor-core rate
# operations per (row, grid point), per (row, D-term checkpoint) and per
# row's pack (belief form), counted from csrc/moment_curves.cu: one per
# arithmetic instruction or math-library call (log1pf, expm1f, expf, logf,
# lgammaf, division)
OPS_PER_POINT = 75
OPS_PER_CHECKPOINT = 35
OPS_PER_PACK = 46
# the refreshed aggregate's largest relative gap, card against CPU, that
# phase 5 showed with the first CUDA kernels, which took rows packed on the
# host (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
AGG_REL_HOST_PACKED = 1.288e-3
TOL_EL = dict(rtol=2e-4, atol=1e-5)     # tests/test_kernels.py of the JAX
TOL_VL = dict(rtol=2e-3, atol=1e-4)     # package: its kernel tolerances
TIE_MARGIN = 1e-4
# attention kernels against their plain versions, by the dtype of the
# inputs. float32 flash: the JAX package's 2e-5 (tests/test_kernels.py).
# bf16 flash returns bf16: within one bf16 ulp (2^-7 of the value) of the
# plain version's float32 result rounded. Decode returns float32 computed
# from the same inputs for either cache type: the float32 limit, 3e-5.
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=8e-3, atol=1e-5)}
DECODE_TOL = dict(rtol=3e-5, atol=3e-5)
# bf16 flash outputs that differ from the plain version's float32 result
# rounded to bf16: at most this share for the kernel, which keeps p in
# float32; a version that rounds p to bf16 before P.V must exceed ten times
# this share, or the check could not tell the two apart
SPLIT_SHARE = 0.01
# one under, at and one over each tile of the bf16 flash kernel, and 1,000
FLASH_EDGE_S = (1, 15, 16, 17, 23, 24, 25, 31, 32, 33, 47, 48, 49, 63, 64,
                65, 127, 128, 129, 191, 192, 193, 1000)
# distinct caches the cold decode timing takes in turn: 6 x 16.8 MB of
# valid K/V at the timed shape, twice the H100's 50 MB L2
COLD_CACHES = 6
BF16_TOL = 2e-2              # layer outputs in bf16
F32_LOGIT_RMS = 1e-4         # float32 logits of the two attention lanes
LOGIT_TIE = 1e-4             # float32 logits closer than this are a tie
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


class phase:
    """``with phase("3. kernels"):`` prints the phase's name, then its wall
    time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   ({self.name}: {time.perf_counter() - self.t0:.1f} s)")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def belief_case(d, n, nd, seed, device, runs=None):
    """``d`` numpy-made beliefs, cores and alive flags ([D] columns, or
    [R, D] for ``runs`` runs), and the kernels' grid (a ``CurveGrid``), on
    ``device``."""
    import numpy as np
    import torch
    from repro_torch.core import geometric_grid
    from repro_torch.core.belief import GammaBelief
    from repro_torch.kernels.moment_curves import ops

    shape = d if runs is None else (runs, d)
    rng = np.random.default_rng(seed)
    e = lambda base: torch.from_numpy(
        (base * np.exp(rng.standard_normal(shape))).astype(np.float32))
    bel = GammaBelief(mu_a=e(0.31), mu_b=e(0.58), lam_a=e(0.49),
                      lam_b=e(0.45), sig_a=e(0.26), sig_b=e(0.055))
    cores = torch.from_numpy(
        (1.0 + rng.poisson(5.0, shape)).astype(np.float32))
    alive = torch.from_numpy(rng.random(shape) < 0.6)
    grid = geometric_grid(6.0, 78_840.0, n, device=device)
    return (GammaBelief(*(x.to(device) for x in bel)), cores.to(device),
            alive.to(device), grid, ops.curve_grid(grid, nd))


def kernel_calls(d, n, nd, seed, device):
    """{kernel name: (launcher, plain version, arguments)} of both forms of
    both kernels on one case."""
    from repro_torch.core import AZURE_PRIORS
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ref as R

    bel, cores, alive, _, (t, idx, frac, _) = belief_case(d, n, nd, seed,
                                                          device)
    params = R.pack_rows(bel, cores, AZURE_PRIORS, alive=alive)
    grid = (t, idx, frac, nd)
    return {
        "moment_curves_agg_belief": (
            K.moment_curves_agg_belief, R.moment_curves_agg_belief_ref,
            (bel, cores, alive, *grid, AZURE_PRIORS)),
        "moment_curves_belief": (
            K.moment_curves_belief, R.moment_curves_belief_ref,
            (bel, cores, *grid, AZURE_PRIORS)),
        "moment_curves_agg_packed": (
            K.moment_curves_agg_packed, R.moment_curves_agg_packed_ref,
            (params, *grid)),
        "moment_curves_packed": (
            K.moment_curves_packed, R.moment_curves_packed_ref,
            (params, *grid)),
    }


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
    median replay time over ``reps``. ``fn`` may be a list of calls, which
    the graph takes in turn (call i is ``fn[i % len(fn)]``): on inputs whose
    bytes together exceed the L2 cache, that times the calls cold."""
    import torch

    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
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


def bound(d, n, nd, aggregate, belief):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM bandwidth, against operations over FP32 peak.
    The belief form reads seven float32 columns (and the bool ALIVE column
    for the aggregate) and packs each row; the packed form reads 16
    floats a row."""
    out_floats = 2 * n if aggregate else 2 * d * n
    row_bytes = (4 * 7 + (1 if aggregate else 0)) if belief else 4 * 16
    nbytes = d * row_bytes + 4 * (3 * n + out_floats)
    ops = d * (n * OPS_PER_POINT + nd * OPS_PER_CHECKPOINT
               + (OPS_PER_PACK if belief else 0))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tolerance_used(got, want, tol):
    """max |got - want| / (atol + rtol |want|): 1.0 is the tolerance."""
    err = (got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs())
    return float(err.max())


def check_kernels():
    """Phase 3: kernels against plain versions; returns the belief-form
    kernels' records at the simulator's shapes."""
    import torch
    from repro_torch.core import AZURE_PRIORS
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ops
    from repro_torch.kernels.moment_curves import ref as R

    worst = {}
    for d in (1, 8, 37, 300, 8192, 8193):
        for n in (12, 48):
            for nd in (8, 24, 32):
                calls = kernel_calls(d, n, nd, d * 1000 + n * 10 + nd, DEVICE)
                for name, (kern, plain, args) in calls.items():
                    el, vl = kern(*args)
                    el2, vl2 = kern(*args)
                    torch.cuda.synchronize()
                    if not (torch.equal(el, el2) and torch.equal(vl, vl2)):
                        raise AssertionError(
                            f"{name} not deterministic at D={d} N={n} "
                            f"ND={nd}")
                    want_el, want_vl = plain(*args)
                    torch.testing.assert_close(el, want_el, **TOL_EL)
                    torch.testing.assert_close(vl, want_vl, **TOL_VL)
                    worst[name] = max(worst.get(name, 0.0),
                                      tolerance_used(el, want_el, TOL_EL),
                                      tolerance_used(vl, want_vl, TOL_VL))
    log("kernels match their plain versions over 36 shapes each; largest "
        "share of the tolerance used: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    for belief in (True, False):
        res = K.agg_residency(belief, 48)
        log(f"aggregate kernel, {'belief' if belief else 'packed'} form, at "
            f"N = 48: {res['registers']} registers, {res['local_bytes']} "
            f"local bytes a thread; {res['ctas_per_sm']} CTA(s) of "
            f"{R.AGG_WARPS} warps an SM on {res['sms']} SMs "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    floor_ms = graph_ms(K.launch_empty)
    log(f"launch floor: an empty kernel takes {floor_ms:.4f} ms on the "
        f"device (CUDA graph), {event_ms(K.launch_empty):.4f} ms a call")

    records = {}
    replaces = {"agg": "src/repro/kernels/moment_curves/kernel.py:103",
                "rows": "src/repro/kernels/moment_curves/kernel.py:95"}
    for agg, (d, n, nd) in ((True, (8192, 48, 24)), (False, (8, 48, 24))):
        calls = kernel_calls(d, n, nd, 11, DEVICE)
        times = {}
        for name, (kern, plain, args) in calls.items():
            if ("agg" in name) != agg:
                continue
            belief = "belief" in name
            el, vl = kern(*args)
            want_el, want_vl = plain(*args)
            max_abs = max(float((el - want_el).abs().max()),
                          float((vl - want_vl).abs().max()))
            b_ms, b_by = bound(d, n, nd, agg, belief)
            times[name] = rec = dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/moment_curves/csrc/"
                       "moment_curves.cu",
                replaces=replaces["agg" if agg else "rows"], launches=0,
                max_abs_err=max_abs,
                ms=event_ms(lambda: kern(*args)),
                plain_ms=event_ms(lambda: plain(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                device_ms=graph_ms(lambda: kern(*args)),
                shape=dict(D=d, N=n, ND=nd))
            log(f"{name} at D={d} N={n} ND={nd}: {rec['ms']:.4f} ms a call "
                f"({rec['device_ms']:.4f} ms on the device, CUDA graph; "
                f"launch floor {floor_ms:.4f}), plain {rec['plain_ms']:.4f} "
                f"ms, bound {b_ms:.6f} ms ({b_by}), max abs err "
                f"{max_abs:.3e}")
        bel, cores, alive, grid, _ = belief_case(d, n, nd, 11, DEVICE)
        if agg:
            new = lambda: ops.aggregate_moment_curves_kernel(
                bel, cores, alive, grid, AZURE_PRIORS, d_points=nd)
            old = lambda: K.moment_curves_agg_packed(
                R.pack_rows(bel, cores, AZURE_PRIORS, alive=alive),
                *ops.curve_grid(grid, nd))
            name = "moment_curves_agg_belief"
        else:
            new = lambda: ops.moment_curves_kernel(bel, cores, grid,
                                                   AZURE_PRIORS, d_points=nd)
            old = lambda: K.moment_curves_packed(
                R.pack_rows(bel, cores, AZURE_PRIORS),
                *ops.curve_grid(grid, nd))
            name = "moment_curves_belief"
        rec = times[name]
        rec["entry_ms"] = event_ms(new)
        rec["packed_path_ms"] = event_ms(old)
        rec["launch_floor_ms"] = floor_ms
        packed = times[name.replace("belief", "packed")]
        rec["packed_form"] = {k: packed[k] for k in ("ms", "device_ms",
                                                     "bound_ms")}
        log(f"{'aggregate_moment_curves_kernel' if agg else 'moment_curves_kernel'}"
            f" at D={d}: {rec['entry_ms']:.4f} ms a call; the packed path "
            f"(pack + grids + packed launch) {rec['packed_path_ms']:.4f} ms")
        records[name] = rec
    return records


def bound_runs(runs, d, n, nd):
    """(bound_ms, bound_by) of the batched aggregate over ``runs`` tables
    of ``d`` rows: seven float32 columns and ALIVE a row read once, the grid
    read once, [runs, 2N] written once; each run's operations."""
    nbytes = runs * d * (4 * 7 + 1) + 4 * (3 * n + runs * 2 * n)
    ops = runs * d * (n * OPS_PER_POINT + nd * OPS_PER_CHECKPOINT
                      + OPS_PER_PACK)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_agg_runs(records, floor_ms):
    """Phase 3, the aggregate over R runs' tables (columns [R, D]) in one
    launch: against its plain version, bit for bit run by run against
    one-run launches, one CUDA kernel a call, and its times at R = 24 and
    240 beside those of R one-run launches in one CUDA graph."""
    import torch
    from repro_torch.core import AZURE_PRIORS
    from repro_torch.core.belief import GammaBelief
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ref as R

    def one_run_args(args, r):
        bel, cores, alive, *rest = args
        return (GammaBelief(*(x[r] for x in bel)), cores[r], alive[r], *rest)

    nd, worst, n_cases = 24, 0.0, 0
    for runs in (1, 3, 24, 240):
        for d in (96, 8192, 8193, 20000):
            for n in (12, 48):
                bel, cores, alive, _, (t, idx, frac, _) = belief_case(
                    d, n, nd, runs * 100_000 + d * 10 + n, DEVICE, runs)
                args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
                el, vl = K.moment_curves_agg_belief(*args)
                el2, vl2 = K.moment_curves_agg_belief(*args)
                torch.cuda.synchronize()
                where = f"R={runs} D={d} N={n}"
                if not (torch.equal(el, el2) and torch.equal(vl, vl2)):
                    raise AssertionError(f"batched aggregate not "
                                         f"deterministic at {where}")
                want_el, want_vl = R.moment_curves_agg_belief_ref(*args)
                torch.testing.assert_close(el, want_el, **TOL_EL)
                torch.testing.assert_close(vl, want_vl, **TOL_VL)
                worst = max(worst, tolerance_used(el, want_el, TOL_EL),
                            tolerance_used(vl, want_vl, TOL_VL))
                del want_el, want_vl
                for r in range(runs):
                    one = K.moment_curves_agg_belief(*one_run_args(args, r))
                    if not (torch.equal(one[0], el[r])
                            and torch.equal(one[1], vl[r])):
                        raise AssertionError(f"run {r} of the batch at "
                                             f"{where} differs from its "
                                             "one-run launch")
                n_cases += 1
    log(f"batched aggregate matches its plain version over {n_cases} "
        f"cases (R 1-240, D 96-20,000, N 12/48; largest share of the "
        f"tolerance used {worst:.3e}) and equals one-run launches bit for "
        "bit, run by run")

    runs, d, n = 24, 8192, 48
    bel, cores, alive, _, (t, idx, frac, _) = belief_case(d, n, nd, 12,
                                                          DEVICE, runs)
    args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
    names = kernels_of_one_call(lambda: K.moment_curves_agg_belief(*args))
    if len(names) != 1 or not ("agg_kernel" in names[0]
                               and "BeliefRow" in names[0]):
        raise AssertionError(f"a batched aggregate call ran {names}")
    log(f"batched aggregate: one CUDA kernel a call in a CUDA graph of it "
        f"({names[0][-60:]})")
    rec = records["moment_curves_agg_belief"]
    rec["runs"] = {}
    for runs in (24, 240):
        bel, cores, alive, _, (t, idx, frac, _) = belief_case(d, n, nd, 13,
                                                              DEVICE, runs)
        args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
        singles = [one_run_args(args, r) for r in range(runs)]
        kern = lambda: K.moment_curves_agg_belief(*args)
        plain = lambda: R.moment_curves_agg_belief_ref(*args)
        one_runs = lambda: [K.moment_curves_agg_belief(*a) for a in singles]
        el, vl = kern()
        want_el, want_vl = plain()
        max_abs = max(float((el - want_el).abs().max()),
                      float((vl - want_vl).abs().max()))
        b_ms, b_by = bound_runs(runs, d, n, nd)
        timed = dict(ms=event_ms(kern), device_ms=graph_ms(kern, reps=20),
                     one_run_launches_device_ms=graph_ms(
                         one_runs, reps=max(2, 480 // runs)),
                     plain_ms=event_ms(plain, reps=10, warm=2),
                     bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs,
                     shape=dict(R=runs, D=d, N=n, ND=nd))
        log(f"moment_curves_agg_belief at R={runs} D={d} N={n} ND={nd}: "
            f"{timed['ms']:.4f} ms a call ({timed['device_ms']:.4f} ms on "
            f"the device, CUDA graph; {runs} one-run launches in a CUDA "
            f"graph {timed['one_run_launches_device_ms']:.4f}; launch floor "
            f"{floor_ms:.4f}), plain {timed['plain_ms']:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), max abs err {max_abs:.3e}")
        rec["runs"][runs] = timed
        del want_el, want_vl


def main_path(records):
    """Phase 4: make_run at PAPER_FULL for SECOND and ZEROTH; returns
    each run's numbers and metrics."""
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
        want = dict.fromkeys(launches, 0)
        if kind == SECOND:
            want.update(moment_curves_agg_belief=n_refresh,
                        moment_curves_belief=cfg.n_steps)
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, want {want}")
        out[name] = dict(utilization=util, failure_rate=fail, wall_s=wall,
                         steps_per_s=cfg.n_steps / wall, metrics=m)
        if kind == SECOND:
            for k in records:
                records[k]["launches"] = launches[k]
    return out



def batch_path(records, single):
    """Phase 4b: phase 4's SECOND run as one batch of 24 seeds."""
    import math

    import torch
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import make_run, split_seeds

    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 48, device=DEVICE)
    seeds = split_seeds(2018, 23)
    seeds.insert(5, 2018)
    run = make_run(cfg, grid, SECOND, device=DEVICE)
    policy = make_policy(SECOND, rho=PAPER_TABLE2["second_rho"],
                         capacity=cfg.capacity)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    m = run(seeds, policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    # one aggregate launch a refresh for all the runs (not one a run)
    want.update(moment_curves_belief=cfg.n_steps,
                moment_curves_agg_belief=cfg.n_steps
                // cfg.agg_refresh_steps)
    if launches != want:
        raise AssertionError(f"batch: launches {launches}, want {want}")
    for field in m:
        if not bool(torch.isfinite(field).all()):
            raise AssertionError("batch: non-finite metrics")
    util = m.utilization.cpu()
    if not bool(((util > 0.0) & (util <= 1.0)).all()):
        raise AssertionError(f"batch: utilizations {util}")
    alone = single["second"]["metrics"]
    for name in alone._fields:
        if not torch.equal(getattr(m, name)[5], getattr(alone, name)):
            raise AssertionError(f"batch run 2018: {name} differs from "
                                 "phase 4's run")
    rate = len(seeds) * cfg.n_steps / wall
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_batch"] = launches[name]
    log(f"PAPER_FULL second, a batch of {len(seeds)} runs: wall "
        f"{wall:.2f} s, {cfg.n_steps / wall:.1f} batched steps/s, "
        f"{rate:.1f} runs x steps/s (phase 4, one run: "
        f"{single['second']['steps_per_s']:.1f} steps/s; "
        f"{rate / single['second']['steps_per_s']:.2f}x); utilization "
        f"mean {float(util.mean()):.4f} (min {float(util.min()):.4f}, max "
        f"{float(util.max()):.4f}), failure rate mean "
        f"{float(m.failure_rate.mean()):.3e}; launches {launches}; run "
        "2018 equals phase 4's bit for bit")
    if not math.isfinite(rate):
        raise AssertionError("batch: no rate")


def table2_quick():
    """Phase 4c: Table 2 at the quick preset on the card."""
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks.table2_policies import NAMES, rows

    scale = common.SCALES["quick"]
    cfg = common.sim_config(scale)
    bench = json.loads((ROOT / "BENCH_quick.json").read_text())["rows"]
    reference = {r["name"].rsplit("/", 1)[1]: r["derived"] for r in bench
                 if r["name"].startswith("tuning/calibrate/")}
    res = {}
    for kind, name in NAMES.items():
        r = res[name] = common.tune_and_eval(scale, kind, cfg, seed=0,
                                             device=DEVICE)
        log(f"table2/{name} at quick ({cfg.n_steps} steps, "
            f"{cfg.max_slots} slots, refresh every {cfg.agg_refresh_steps}, "
            f"{scale.n_runs} runs): theta {r['param']:.6g}, utilization "
            f"{r['utilization']:.4f} (BCa {r['ci_lo']:.4f}:{r['ci_hi']:.4f}), "
            f"SLA {r['sla_fail']:.3e} (ci {r['sla_lo']:.2e}:"
            f"{r['sla_hi']:.2e}) <= tau {r['tau']:.0e}, stages "
            f"{[len(st) for st in r['stages']]}, {r['n_sims']} simulations, "
            f"{r['seconds']:.1f} s ({r['run_steps'] / r['seconds']:.0f} "
            f"runs x steps/s); the JAX package (BENCH_quick.json): "
            f"{reference.get(name, 'none')}")
        if not (r["feasible"] and r["sla_fail"] <= r["tau"]):
            raise AssertionError(f"table2/{name}: theta {r['param']} is not "
                                 f"feasible (SLA {r['sla_fail']})")
    for row in rows(res):
        log("  " + row)


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
        f"largest relative difference {agg_rel:.3e} (rows packed on the "
        f"host: {AGG_REL_HOST_PACKED:.3e}); utilization "
        f"{float(metrics[DEVICE].utilization):.4f} on both")


def start_builds():
    """One nvcc per CUDA source, all started together; returns the kernel
    modules and a future per module (the seconds its build took)."""
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.moment_curves import kernel as MC

    def build(mod):
        t0 = time.perf_counter()
        mod._library()
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=3)
    futures = {mod: pool.submit(build, mod) for mod in (MC, FA, DG)}
    pool.shutdown(wait=False)
    return futures


def report_build(mod, future):
    from repro_torch.kernels._build import build_report

    seconds = future.result()
    nvcc_log, nvcc_s = build_report(mod.SOURCE)
    log(f"built {mod.SOURCE.name} in {seconds:.2f} s (nvcc {nvcc_s:.2f} s)")
    for line in nvcc_log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "error",
                                   "warning", "Compiling entry")):
            log("  " + line.strip())


def randn(shape, gen, dtype):
    import torch

    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(dtype)


def dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def sdpa(q, k, v, causal):
    """One PyTorch call for the same attention ([B, S, H, Dh] inputs), the
    yardstick ``library_ms``; the port never calls it."""
    import torch.nn.functional as F

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def attention_bound(nbytes, flops):
    """(bound_ms, bound_by): bytes over HBM bandwidth against operations
    over the bf16 tensor-core peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash():
    """Phase 7, flash: the kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    worst, n = {}, 0
    # bf16 cases: outputs off the rounded float32 result, and the sums of
    # |out - float32 result| and |float32 result|, for the kernel and for
    # the plain version with p rounded to bf16
    split = {lane: dict(off=0, err=0.0) for lane in ("kernel", "p in bf16")}
    n_bf16, scale = 0, 0.0
    cases = [(b, s, heads, dtype, causal, window)
             for b in (1, 2) for s in (1, 100, 128, 1000, 2048, 4096)
             for heads in ((32, 8, 64), (8, 2, 128))
             for dtype in (torch.bfloat16, torch.float32)
             for causal, window in ((True, 0), (True, 1024))]
    cases += [(2, s, (32, 8, 64), torch.bfloat16, False, 0)
              for s in (128, 2048)]
    # the bf16 kernel's edges: sequence lengths around its tiles (64 keys;
    # 192 / G query positions at Dh = 64 and 128 / G at Dh = 128) for
    # G = 1, 4 and 8
    cases += [(1, s, heads, torch.bfloat16, True, window)
              for s in FLASH_EDGE_S
              for heads in ((8, 8, 64), (8, 2, 64), (32, 4, 64),
                            (8, 8, 128), (8, 2, 128), (16, 2, 128))
              for window in (0, 100)]
    for b, s, (h, kvh, dh), dtype, causal, window in cases:
        q = randn((b, s, h, dh), gen, dtype)
        k = randn((b, s, kvh, dh), gen, dtype)
        v = randn((b, s, kvh, dh), gen, dtype)
        got = FA.flash_attention_bshd(q, k, v, causal=causal, window=window)
        again = FA.flash_attention_bshd(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash not deterministic at B={b} S={s} "
                                 f"H={h} {dtype} window={window}")
        # the plain version in float32 on the same values; rounded to q's
        # dtype it is exactly ``flash_attention_ref(q, k, v)``
        want32 = FR.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=causal, window=window)
        want = want32.to(dtype)
        name = dtype_name(dtype)
        tol = FLASH_TOL[name]
        torch.testing.assert_close(got.float(), want.float(), **tol)
        worst[name] = max(worst.get(name, 0.0),
                          tolerance_used(got.float(), want.float(), tol))
        if dtype == torch.bfloat16:
            rounded = FR.flash_attention_ref(q, k, v, causal=causal,
                                             window=window,
                                             p_dtype=torch.bfloat16)
            for lane, out in (("kernel", got), ("p in bf16", rounded)):
                split[lane]["off"] += int((out != want).sum())
                split[lane]["err"] += float((out.float() - want32).abs().sum())
            n_bf16 += got.numel()
            scale += float(want32.abs().sum())
            del rounded
        n += 1
        del q, k, v, got, again, want, want32
    fused_qkv_and_misaligned(gen)
    log(f"flash_attention matches its plain version over {n} cases; largest "
        "share of the tolerance used: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    share = {lane: s["off"] / n_bf16 for lane, s in split.items()}
    log("bf16 outputs off the plain version's float32 result rounded to "
        "bf16: " + ", ".join(
            f"{lane} {share[lane]:.4e} (mean |error| / mean |output| "
            f"{s['err'] / scale:.4e})" for lane, s in split.items())
        + f", over {n_bf16:,} outputs")
    if share["kernel"] > SPLIT_SHARE:
        raise AssertionError(f"bf16 flash: {share['kernel']:.3e} of the "
                             "outputs are off the rounded float32 result")
    if share["p in bf16"] <= 10 * SPLIT_SHARE:
        raise AssertionError("rounding p to bf16 moves only "
                             f"{share['p in bf16']:.3e} of the outputs: the "
                             "check cannot tell it from float32 p")


def fused_qkv_and_misaligned(gen):
    """bf16 flash on q, k and v as views of one [B, S, H + 2 KVH, Dh]
    tensor (a fused QKV projection's output) gives the bits it gives on
    contiguous copies; a view TMA cannot copy is refused, and nothing is
    launched for it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as FA

    for b, s, h, kvh, dh in ((2, 2048, 32, 8, 64), (1, 1000, 16, 2, 128)):
        qkv = randn((b, s, h + 2 * kvh, dh), gen, torch.bfloat16)
        views = (qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:])
        got = FA.flash_attention_bshd(*views, causal=True)
        want = FA.flash_attention_bshd(*(x.contiguous() for x in views),
                                       causal=True)
        if not torch.equal(got, want):
            raise AssertionError(f"fused QKV views differ from copies at "
                                 f"H={h} Dh={dh}")
    wide = randn((1, 64, 8, 72), gen, torch.bfloat16)
    k = randn((1, 64, 2, 64), gen, torch.bfloat16)
    before = FA.LAUNCHES["flash_attention"]
    try:
        FA.flash_attention_bshd(wide[..., 1:65], k, k, causal=True)
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    else:
        raise AssertionError("a misaligned bf16 view was not refused")
    if FA.LAUNCHES["flash_attention"] != before:
        raise AssertionError("a refused view was launched")
    log("flash_attention on fused-QKV views: equal bits to contiguous "
        "copies (Dh 64 and 128); a view one element off is refused")


def check_decode():
    """Phase 7, decode: the kernel against its plain version on the card."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    worst, n = {}, 0
    for b in (1, 4):
        for s in (1, 77, 2048, 8192):
            length_sets = ([[1], [s]] if b == 1 else
                           [[1, s, (s + 1) // 2, 0], [s] * 4])
            for h, kvh, dh in ((32, 8, 64), (8, 1, 128)):
                for q_dtype, kv_dtype in ((bf16, bf16), (f32, f32),
                                          (bf16, f32)):
                    q = randn((b, h, dh), gen, q_dtype)
                    k = randn((b, s, kvh, dh), gen, kv_dtype)
                    v = randn((b, s, kvh, dh), gen, kv_dtype)
                    for lengths in length_sets:
                        lens = torch.tensor(lengths, dtype=torch.int32,
                                            device=DEVICE)
                        got = DG.decode_gqa_bshd(q, k, v, lens)
                        again = DG.decode_gqa_bshd(q, k, v, lens)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(
                                f"decode not deterministic at B={b} S={s}")
                        want = DR.decode_gqa_ref(q, k, v, lens)
                        torch.testing.assert_close(got, want, **DECODE_TOL)
                        name = dtype_name(kv_dtype)
                        worst[name] = max(worst.get(name, 0.0),
                                          tolerance_used(got, want,
                                                         DECODE_TOL))
                        n += 1
    log(f"decode_gqa matches its plain version over {n} cases (lengths "
        "0, 1, S/2 and S); largest share of the tolerance used: "
        + ", ".join(f"{k} cache {v:.3e}" for k, v in worst.items()))
    decode_edges(gen)
    decode_misaligned_and_one_kernel(gen)


def decode_case(q, k, v, lengths, worst):
    """One decode case: bitwise repeat, zeros at length 0, the plain version
    at DECODE_TOL; records the share of the tolerance used."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR

    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = DG.decode_gqa_bshd(q, k, v, lens)
    again = DG.decode_gqa_bshd(q, k, v, lens)
    torch.cuda.synchronize()
    where = (f"B={q.shape[0]} H={q.shape[1]} KVH={k.shape[2]} "
             f"Dh={q.shape[2]} q {dtype_name(q.dtype)} cache "
             f"{dtype_name(k.dtype)} lengths {lengths}")
    if not torch.equal(got, again):
        raise AssertionError(f"decode not deterministic at {where}")
    for row, n in enumerate(lengths):
        if n == 0 and bool(got[row].any()):
            raise AssertionError(f"decode: a row of length 0 is not zeros "
                                 f"at {where}")
    want = DR.decode_gqa_ref(q, k, v, lens)
    torch.testing.assert_close(got, want, **DECODE_TOL, msg=lambda m: (
        f"decode at {where}: {m}"))
    name = f"{dtype_name(k.dtype)} cache"
    worst[name] = max(worst.get(name, 0.0),
                      tolerance_used(got, want, DECODE_TOL))


def decode_edges(gen):
    """Phase 7, decode at the edges of the cluster kernel: G = 1, 2, 4, 8,
    16; Dh = 64, 128, 256; each pairing of a bf16 / float32 query and cache;
    B = 4 and 1; lengths 0, 1, one under, at and one over a key tile and a
    split's share (8 splits x tile), S/2 and S."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR

    bf16, f32 = torch.bfloat16, torch.float32
    lib = DG._library()
    worst, n, s, h = {}, 0, 2560, 16
    for g in (1, 2, 4, 8, 16):
        for dh in (64, 128, 256):
            for q_dtype, kv_dtype in ((bf16, bf16), (f32, f32), (bf16, f32),
                                      (f32, bf16)):
                kvh = h // g
                q = randn((4, h, dh), gen, q_dtype)
                k = randn((4, s, kvh, dh), gen, kv_dtype)
                v = randn((4, s, kvh, dh), gen, kv_dtype)
                tile = DR.key_tile(k.element_size(), dh)
                if lib.dg_key_tile(k.element_size(), dh) != tile:
                    raise AssertionError("ref.key_tile disagrees with the "
                                         f"kernel's at Dh={dh}")
                share = DG.N_SPLITS * tile
                edges = [min(x, s) for x in (
                    0, 1, tile - 1, tile, tile + 1, share - 1, share,
                    share + 1, s // 2, s, s - 1, 0)]
                for i in range(0, len(edges), 4):
                    decode_case(q, k, v, edges[i:i + 4], worst)
                    n += 1
                for length in (tile + 1, s):
                    decode_case(q[:1], k[:1], v[:1], [length], worst)
                    n += 1
                del q, k, v
    log(f"decode_gqa at the cluster kernel's edges: {n} more cases (G 1-16, "
        "Dh 64/128/256, bf16/float32 q and cache, B 4 and 1, lengths "
        "around the key tile and the split share) match; "
        "largest share of the tolerance used: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def decode_misaligned_and_one_kernel(gen):
    """A cache view that the 16-byte loads cannot read is refused, and
    nothing is launched for it; one call is one CUDA kernel."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG

    q = randn((2, 8, 64), gen, torch.bfloat16)
    wide = randn((2, 128, 2, 72), gen, torch.bfloat16)
    lens = torch.tensor([5, 128], dtype=torch.int32, device=DEVICE)
    before = DG.LAUNCHES["decode_gqa"]
    try:
        DG.decode_gqa_bshd(q, wide[..., 1:65], wide[..., :64], lens)
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    else:
        raise AssertionError("a misaligned decode cache was not refused")
    if DG.LAUNCHES["decode_gqa"] != before:
        raise AssertionError("a refused decode view was launched")
    b, h, kvh, dh, slots = 4, 32, 8, 64, 4096
    q = randn((b, h, dh), gen, torch.bfloat16)
    k = randn((b, slots, kvh, dh), gen, torch.bfloat16)
    lens = torch.tensor([2048, 1, 0, slots], dtype=torch.int32,
                        device=DEVICE)
    names = kernels_of_one_call(lambda: DG.decode_gqa_bshd(q, k, k, lens))
    if len(names) != 1 or "decode_cluster_kernel" not in names[0]:
        raise AssertionError(f"a decode call ran {len(names)} CUDA kernels: "
                             f"{names}")
    log("decode_gqa: a view one element off is refused; one call is one "
        f"CUDA kernel in a CUDA graph of it ({names[0][:60]})")


def kernels_of_one_call(fn):
    """The CUDA kernels that one call of ``fn`` runs, counted from a CUDA
    graph of the call (``repro_torch.kernels._graph``): each kernel node by
    its function's name, any other node (a memset, a copy) as ``<type
    node>``."""
    from repro_torch.kernels._graph import kernels_of_one_call as graph_count

    names, others = graph_count(fn)
    return names + [f"<{kind} node>" for kind in others]


def time_attention_kernels(records):
    """Phase 7, times at llama3.2-1b's shapes: flash at B = 2, S = 2,048,
    causal, bf16; decode at B = 4, 2,048 valid keys of a 4,096-slot bf16
    cache."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    bf16 = torch.bfloat16
    b, s, h, kvh, dh = 2, 2048, 32, 8, 64
    q = randn((b, s, h, dh), gen, bf16)
    k = randn((b, s, kvh, dh), gen, bf16)
    v = randn((b, s, kvh, dh), gen, bf16)
    kern = lambda: FA.flash_attention_bshd(q, k, v, causal=True)
    plain = lambda: FR.flash_attention_ref(q, k, v, causal=True)
    err = float((kern().float() - plain().float()).abs().max())
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * b * h * dh * (s * (s + 1) // 2)
    b_ms, b_by = attention_bound(nbytes, flops)
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:30",
        launches=0, max_abs_err=err, ms=event_ms(kern),
        plain_ms=event_ms(plain, reps=10, warm=2), bound_ms=b_ms,
        bound_by=b_by, library_ms=event_ms(lambda: sdpa(q, k, v, True)),
        device_ms=graph_ms(kern),
        library_device_ms=graph_ms(lambda: sdpa(q, k, v, True)),
        shape=dict(B=b, S=s, H=h, KVH=kvh, Dh=dh, dtype="bfloat16",
                   causal=True))
    del q, k, v
    # the Dh = 128 instance at the same operations: H = 16 over KVH = 4
    h2, kvh2, dh2 = 16, 4, 128
    q = randn((b, s, h2, dh2), gen, bf16)
    k = randn((b, s, kvh2, dh2), gen, bf16)
    v = randn((b, s, kvh2, dh2), gen, bf16)
    kern = lambda: FA.flash_attention_bshd(q, k, v, causal=True)
    b_ms2, b_by2 = attention_bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                                   4 * b * h2 * dh2 * (s * (s + 1) // 2))
    records["flash_attention"]["dh128"] = dict(
        ms=event_ms(kern), device_ms=graph_ms(kern),
        library_ms=event_ms(lambda: sdpa(q, k, v, True)),
        library_device_ms=graph_ms(lambda: sdpa(q, k, v, True)),
        bound_ms=b_ms2, bound_by=b_by2,
        max_abs_err=float((kern().float() - FR.flash_attention_ref(
            q, k, v, causal=True).float()).abs().max()),
        shape=dict(B=b, S=s, H=h2, KVH=kvh2, Dh=dh2, dtype="bfloat16",
                   causal=True))
    del q, k, v

    b, slots, valid = 4, 4096, 2048
    q = randn((b, h, dh), gen, bf16)
    k = randn((b, slots, kvh, dh), gen, bf16)
    v = randn((b, slots, kvh, dh), gen, bf16)
    lens = torch.full((b,), valid, dtype=torch.int32, device=DEVICE)
    kern = lambda: DG.decode_gqa_bshd(q, k, v, lens)
    plain = lambda: DR.decode_gqa_ref(q, k, v, lens)
    err = float((kern() - plain()).abs().max())
    nbytes = 2 * 2 * b * valid * kvh * dh + 2 * q.numel() + 4 * q.numel()
    flops = 4 * b * h * valid * dh
    b_ms, b_by = attention_bound(nbytes, flops)
    kv = (k[:, :valid], v[:, :valid])
    # cold: the graph takes COLD_CACHES distinct caches in turn, whose valid
    # K/V together exceed the 50 MB L2
    caches = [(randn(k.shape, gen, bf16), randn(v.shape, gen, bf16))
              for _ in range(COLD_CACHES)]
    cold_bytes = COLD_CACHES * 2 * 2 * b * valid * kvh * dh
    if cold_bytes <= 50e6:
        raise AssertionError(f"cold caches hold {cold_bytes:,} valid bytes")
    records["decode_gqa"] = dict(
        name="decode_gqa", route="cuda",
        source="src/repro_torch/kernels/decode_gqa/csrc/decode_gqa.cu",
        replaces="src/repro/kernels/decode_gqa/kernel.py:26",
        launches=0, max_abs_err=err, ms=event_ms(kern),
        plain_ms=event_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=event_ms(lambda: sdpa(q[:, None], *kv, False)),
        device_ms=graph_ms(kern),
        library_device_ms=graph_ms(lambda: sdpa(q[:, None], *kv, False)),
        device_ms_cold=graph_ms([
            lambda kc=kc, vc=vc: DG.decode_gqa_bshd(q, kc, vc, lens)
            for kc, vc in caches]),
        library_device_ms_cold=graph_ms([
            lambda kc=kc, vc=vc: sdpa(q[:, None], kc[:, :valid],
                                      vc[:, :valid], False)
            for kc, vc in caches]),
        cold_valid_bytes=cold_bytes,
        clusters_needed=b * kvh,
        clusters_resident=DG.max_active_clusters(),
        shape=dict(B=b, slots=slots, valid=valid, H=h, KVH=kvh, Dh=dh,
                   dtype="bfloat16"))
    del caches
    rows = [(name, records[name]) for name in ("flash_attention",
                                               "decode_gqa")]
    rows.insert(1, ("flash_attention", records["flash_attention"]["dh128"]))
    for name, r in rows:
        plain = f"plain {r['plain_ms']:.4f} ms, " if "plain_ms" in r else ""
        cold = (f"; cold ({COLD_CACHES} caches in turn, "
                f"{r['cold_valid_bytes'] / 1e6:.1f} MB valid) "
                f"{r['device_ms_cold']:.4f} ms on the device, SDPA "
                f"{r['library_device_ms_cold']:.4f}; {r['clusters_needed']} "
                f"clusters of {DG.N_SPLITS} a call, {r['clusters_resident']} "
                "resident at once"
                if "device_ms_cold" in r else "")
        log(f"{name} at {r['shape']}: {r['ms']:.4f} ms a call "
            f"({r['device_ms']:.4f} ms on the device, CUDA graph), {plain}"
            f"SDPA {r['library_ms']:.4f} ms ({r['library_device_ms']:.4f} ms "
            f"on the device){cold}, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}), max abs err {r['max_abs_err']:.3e}")


def profile_device(fn):
    """(wall ms, device-busy ms, kernels launched, {kernel: device ms}) of
    one call of ``fn``, from torch.profiler's CUDA events."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += 1e-3 * e.time_range.elapsed_us()
    return 1e3 * wall, sum(by_name.values()), len(kernels), by_name


def wall_s(fn, reps=3):
    """Median host wall time of ``fn`` to a synchronised end."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def compare_logits(got, want):
    """(max |diff|, rms diff / rms want, share of equal argmax)."""
    got, want = got.float(), want.float()
    rms = float((got - want).square().mean().sqrt()
                / want.square().mean().sqrt())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return float((got - want).abs().max()), rms, same


def layer_by_layer(cfg, params, tokens):
    """The flash lane's forward, with each layer's attention also run
    through the einsum lane on the same input: the largest rms difference
    of the two, relative to the output's rms, over the layers."""
    import torch
    from repro_torch.models.layers import attention, mlp, rmsnorm

    acfg = cfg.attn_config()
    x = params["embed"][tokens].to(cfg.dtype)
    worst = 0.0
    for p in params["layers"]:
        h = rmsnorm(p["ln1"], x)
        got = attention(p["attn"], acfg, h, use_kernel=True)
        want = attention(p["attn"], acfg, h, use_kernel=False)
        worst = max(worst, compare_logits(got, want)[1])
        x = x + got
        x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        torch.cuda.synchronize()
    return worst


def rope_long_positions(cfg):
    """RoPE at llama3.2-1b's theta out to 8,192 positions, card against the
    port's CPU path (the CPU tests stop at 64 positions)."""
    import torch
    from repro_torch.models.layers import rope

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    x = randn((1, 8192, 8, cfg.resolved_head_dim), gen, torch.float32)
    pos = torch.arange(8192, device=DEVICE)
    got = rope(x, pos, cfg.rope_theta).cpu()
    err = float((got - rope(x.cpu(), pos.cpu(), cfg.rope_theta)).abs().max())
    log(f"rope, theta {cfg.rope_theta:g}, positions < 8192, float32: card "
        f"against CPU max |diff| {err:.3e}")
    if err > 1e-4:
        raise AssertionError(f"rope differs by {err:.3e}")


def lm_forward(cfg, params, records):
    """Phase 8: llama3.2-1b forward, flash lane on and off."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import DecoderLM

    rope_long_positions(cfg)

    def lanes(dtype):
        return {lane: DecoderLM(dataclasses.replace(
            cfg, use_flash_kernel=lane, dtype=dtype)) for lane in (True, False)}

    rng = np.random.default_rng(8)
    for b, s in ((2, 2048), (2, 1000)):
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)).to(DEVICE)
        models = lanes(cfg.dtype)
        torch.cuda.synchronize()
        FA.reset_launches()
        flash = models[True].forward(params, tokens)
        torch.cuda.synchronize()
        launches = FA.LAUNCHES["flash_attention"]
        if launches != cfg.n_layers:
            raise AssertionError(f"flash lane launched {launches} kernels, "
                                 f"want {cfg.n_layers}")
        if flash.shape != (b, s, cfg.vocab) or flash.dtype != cfg.dtype:
            raise AssertionError(f"logits {flash.shape} {flash.dtype}")
        if not bool(torch.isfinite(flash).all()):
            raise AssertionError("non-finite logits")
        diff, rms, same = compare_logits(
            flash, models[False].forward(params, tokens))
        del flash
        layer_rms = layer_by_layer(cfg, params, tokens)
        log(f"forward B={b} S={s}, bf16: flash lane {launches} launches; "
            f"logits against the einsum lane: max |diff| {diff:.3e}, rms "
            f"diff / rms {rms:.3e}, equal argmax {same:.4f}; per layer, "
            f"attention rms diff / rms at most {layer_rms:.3e}")
        # In bf16 the lanes round at different places (the einsum lane
        # rounds the probabilities to bf16 before P.V, the kernel keeps
        # them in float32, as phase 7 checks), and 16 layers carry that on
        # to the logits. So each layer's attention is held to the bf16
        # tolerance on the same input, and the float32 forward to a tight
        # one.
        if layer_rms > BF16_TOL or rms > 5 * BF16_TOL or same < 0.9:
            raise AssertionError("bf16 lanes disagree")
        f32 = lanes(torch.float32)
        diff32, rms32, same32 = compare_logits(
            f32[True].forward(params, tokens),
            f32[False].forward(params, tokens))
        log(f"forward B={b} S={s}, float32: logits max |diff| "
            f"{diff32:.3e}, rms diff / rms {rms32:.3e}, equal argmax "
            f"{same32:.4f}")
        if rms32 > F32_LOGIT_RMS:
            raise AssertionError(f"float32 lanes differ by {rms32:.3e}")
        if s == 2048:
            records["flash_attention"]["launches"] = launches
            for lane, model in models.items():
                secs = wall_s(lambda: model.forward(params, tokens))
                log(f"  bf16, flash lane {'on ' if lane else 'off'}: "
                    f"{1e3 * secs:.1f} ms a forward, {b * s / secs:.0f} "
                    "tokens/s")
            wall, busy, n_k, by_name = profile_device(
                lambda: models[True].forward(params, tokens))
            fa_ms = sum(t for k, t in by_name.items() if "flash_fwd" in k)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            log(f"  profile, flash lane: wall {wall:.1f} ms, device busy "
                f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}), {n_k} "
                f"kernels, flash kernel {fa_ms:.1f} ms "
                f"({fa_ms / busy:.3f} of busy); top: "
                + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in top))


def decode_layer(cfg, params, records):
    """Phase 9: layer 0's attention, decode kernel lane against the einsum
    lane, 64 positions."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.models.layers import KVCache, attention_decode

    p, acfg = params["layers"][0]["attn"], cfg.attn_config()
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    b, slots, filled, steps = 4, 4096, 2048, 64
    shape = (b, slots, acfg.n_kv_heads, acfg.head_dim)
    k = torch.zeros(shape, dtype=torch.bfloat16, device=DEVICE)
    v = torch.zeros_like(k)
    k[:, :filled] = randn((b, filled, *shape[2:]), gen, torch.bfloat16)
    v[:, :filled] = randn((b, filled, *shape[2:]), gen, torch.bfloat16)
    length = torch.tensor(filled, dtype=torch.int32, device=DEVICE)
    caches = {lane: KVCache(k.clone(), v.clone(), length)
              for lane in (True, False)}
    xs = [randn((b, 1, cfg.d_model), gen, torch.bfloat16)
          for _ in range(steps)]
    torch.cuda.synchronize()
    DG.reset_launches()
    worst = 0.0
    for i, x in enumerate(xs):
        out = {}
        for lane in (True, False):
            out[lane], caches[lane] = attention_decode(
                p, acfg, x, caches[lane], use_kernel=lane)
        got, want = out[True].float(), out[False].float()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"step {i}: non-finite output")
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > BF16_TOL:
            raise AssertionError(f"step {i}: lanes differ by {rel:.3e} of "
                                 "the largest output")
        worst = max(worst, rel)
    torch.cuda.synchronize()
    launches = DG.LAUNCHES["decode_gqa"]
    if launches != steps:
        raise AssertionError(f"decode lane launched {launches}, want {steps}")
    if not (torch.equal(caches[True].k, caches[False].k)
            and int(caches[True].length) == filled + steps):
        raise AssertionError("the lanes' caches differ")
    records["decode_gqa"]["launches"] = launches
    log(f"decode layer 0, B={b}, {filled} -> {filled + steps} of {slots} "
        f"slots: {launches} kernel launches; kernel lane against einsum "
        f"lane, largest |diff| / largest |output| {worst:.3e}")


def server_profile(model, params, args, steps=8):
    """Where a server decode step's time goes: ``steps`` decode steps at
    the server's batch and float32 cache, under torch.profiler."""
    import torch

    state = {"cache": model.init_cache(args.max_batch, args.max_seq,
                                       dtype=torch.float32, device=DEVICE)}
    tokens = torch.arange(2, 2 + args.max_batch, device=DEVICE)

    def decode():
        for _ in range(steps):
            _, state["cache"] = model.decode_step(params, tokens,
                                                  state["cache"])

    decode()
    wall, busy, n_k, by_name = profile_device(decode)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"  profile, server decode step (B={args.max_batch}): wall "
        f"{wall / steps:.2f} ms, device busy {busy / steps:.2f} ms (idle "
        f"share {1 - busy / wall:.3f}), {n_k / steps:.0f} kernels a step; "
        "top: " + "; ".join(f"{k[:50]} {t / steps:.3f} ms" for k, t in top))


def server(cfg, model, params):
    """Phase 10: the launcher's server at full width, then card against
    CPU at 2 layers in float32."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import DecoderLM
    from repro_torch.serve import ServeEngine

    args = S.parse_args([])
    outs = {}
    for mode in ("fused", "loop"):
        reqs, done, secs = S.serve(model, params, args, cfg.vocab,
                                   prefill_mode=mode)
        tokens = sum(len(r.out_tokens) for r in reqs)
        if len(done) != len(reqs) or not all(
                r.done and 1 <= len(r.out_tokens) <= args.max_new
                for r in reqs):
            raise AssertionError(f"{mode}: {len(done)}/{len(reqs)} answered")
        log(f"server ({mode} prefill): {len(done)}/{len(reqs)} requests, "
            f"{tokens} tokens in {secs:.2f} s ({tokens / secs:.1f} tokens/s)")
        outs[mode] = [tuple(r.out_tokens) for r in reqs]
    if outs["fused"] != outs["loop"]:
        raise AssertionError("fused and loop prefill give different tokens")
    log("fused and loop prefill give equal tokens; first request -> "
        f"{list(outs['fused'][0])}")
    server_profile(model, params, args)

    class Recording(ServeEngine):
        def _greedy(self, logits):
            top = torch.topk(logits, 4, dim=-1)
            self.script.append((top.values.cpu(), top.indices.cpu()))
            return super()._greedy(logits)

    class Following(ServeEngine):
        def _greedy(self, logits):
            mine = super()._greedy(logits)
            vals, idx = self.script[len(self.seen)]
            want = idx[:, 0].numpy().astype(np.int32)
            self.seen.append(float((torch.topk(logits, 1).values[:, 0].cpu()
                                    - vals[:, 0]).abs().max()))
            for row in np.flatnonzero(mine != want):
                hit = (idx[row] == int(mine[row])).nonzero()
                if len(hit) == 0:
                    raise AssertionError(f"card token {mine[row]} is not in "
                                         "the CPU's top 4")
                margin = float(vals[row, 0] - vals[row, int(hit[0, 0])])
                if margin >= LOGIT_TIE:
                    raise AssertionError(f"tokens differ at margin {margin}")
                self.ties.append(margin)
            return want

    small = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    small_model = DecoderLM(small)
    p_cpu = small_model.init(torch.Generator().manual_seed(1), device="cpu")
    p_card = copy.deepcopy(p_cpu).to(DEVICE)
    engines = {}
    for name, cls, p in (("cpu", Recording, p_cpu),
                         ("card", Following, p_card)):
        engine = cls(small_model, p, max_batch=args.max_batch,
                     max_seq=args.max_seq)
        engine.script = engines["cpu"].script if name == "card" else []
        engine.seen, engine.ties = [], []
        reqs = S.make_requests(args, small.vocab)
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        engine.reqs = reqs
        engines[name] = engine
    cpu, card = engines["cpu"], engines["card"]
    if [r.out_tokens for r in cpu.reqs] != [r.out_tokens for r in card.reqs]:
        raise AssertionError("card and CPU engines emitted different tokens")
    margins = [float((v[:, 0] - v[:, 1]).min()) for v, _ in cpu.script]
    log(f"card against CPU (llama3.2-1b width, 2 layers, float32, "
        f"{len(cpu.script)} decode steps): tokens equal, {len(card.ties)} "
        f"float32 ties (margin < {LOGIT_TIE}); smallest top-2 margin on the "
        f"CPU {min(margins):.3e}; largest |top-1 logit| difference "
        f"{max(card.seen):.3e}")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs the "
                 "port on a card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    # the card is compared with the CPU in float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("1. card"):
        card = card_line()
        log(card)

    with phase("2. build"):
        builds = start_builds()
        mc = next(iter(builds))
        report_build(mc, builds[mc])

    with phase("3. kernels against their plain versions"):
        records = check_kernels()
        check_agg_runs(records, records["moment_curves_agg_belief"][
            "launch_floor_ms"])

    with phase("4. main path at PAPER_FULL"):
        single = main_path(records)

    with phase("4b. a batch of 24 runs at PAPER_FULL"):
        batch_path(records, single)

    with phase("4c. Table 2 at the quick preset"):
        table2_quick()

    with phase("5. card against CPU, in lockstep"):
        lockstep()

    with phase("6. build the attention kernels"):
        for mod, future in list(builds.items())[1:]:
            report_build(mod, future)

    with phase("7. attention kernels against their plain versions"):
        check_flash()
        check_decode()
        time_attention_kernels(records)

    from repro_torch.launch import serve as S

    with phase("8. LM forward, llama3.2-1b at full width"):
        cfg, model, params = S.build(S.parse_args([]))
        log(f"{cfg.name}: {model.n_params():,} parameters (float32), "
            f"{cfg.n_layers} layers, activations {dtype_name(cfg.dtype)}")
        lm_forward(cfg, params, records)

    with phase("9. decode layer with the kernel lane"):
        decode_layer(cfg, params, records)

    with phase("10. server"):
        server(cfg, model, params)

    log(card)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
