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
               beside R one-run launches in one CUDA graph. Then the §6/§7
               inputs: both belief-form kernels on beliefs after 50 pseudo
               observations (mu_a >= 50), and the row kernel on the
               unlabeled mode's 2 A and 2 x 24 A rows (both mixture
               components in one launch) bit for bit against one launch a
               component; the largest relative error of each case.
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
  4d. modes  — SECOND with Def. 4's heuristic at PAPER_FULL cut to 180
               days (720 of its 4,380 steps, to make room for phase 12)
               in the GLOBAL, §6 PSEUDO (50 observations) and §7 unlabeled
               (5 of each type) modes, each a batch of 24 runs: one
               row-kernel launch a step (both mixture components' rows in
               it) and one aggregate a refresh; run 0 equal to its run
               alone bit for bit; runs x steps/s, launches a step,
               utilization.
  4e. figures — ``repro_torch.benchmarks`` ``fig1_priors`` and
               ``fig2_pricing`` (with §8's fees) at the ``quick`` preset,
               each row beside the paper's number (not a gate;
               utilizations finite in (0, 1]). The marginal ablation, whose
               rows with the heuristic are Fig. 1's, runs through its
               module command (``python -m
               repro_torch.benchmarks.ablation_marginal --scale quick``).
  5. lockstep — a card core and a CPU core on one arrival stream and the
               same per-step events: equal decisions (up to float32 ties)
               and equal final metrics; the refreshed aggregate's largest
               relative gaps (E[L], V[L]), card against CPU. Again with 50
               pseudo observations (Def. 4's heuristic), where every
               refresh's gap must stay below a fixed limit and a decision
               may differ only at a margin below it; the count of
               decisions whose margin lies inside their refresh's gap.
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
 11. online engine — ``repro_torch.serve.OnlineAdmissionEngine`` at
               PAPER_FULL (phase 4's SECOND run: seed 2018, rho 0.112, the
               ``full`` grid, K = 12, micro-batch 8), ticked with phase 4's
               generator and deciding its stream through ``decide_slice``
               for all 4,380 ticks: accept masks and metrics equal phase 4's
               bit for bit, 365 aggregate and 4,380 row launches; ticks/s,
               decisions/s, a flush's host ms (p50/p99) and device ms
               between CUDA events. Again with the telemetry rider (same
               bits; admits + rejects = decisions). The naive lane for 200
               ticks (one aggregate launch a request). The deadline
               scheduler (SLO 50 ms) fed by a ticker thread and 4 submitter
               threads for 500 ticks: every future resolves; misses and
               latency p50/p99 against the SLO; one ``GET /metrics`` from
               an ephemeral port, parsed, carrying the rider's counters.
               Last, a profile of 48 ticks (kernels a tick, idle share).
 12. fleet   — ``make_fleet_run`` at PAPER_FULL split as the JAX package's
               fleet benchmark splits it: 8,000 / 6,000 / 4,000 / 2,000
               cores, 4,096 slots each, SECOND rho 0.112 through
               ``fleet_policy``. A fleet of one (all 20,000 cores, 8,192
               slots) takes phase 4's decisions bit for bit. Each router
               (least utilized and power of two for all 4,380 steps,
               random and cascade for 720) holds tests/test_fleet.py's
               invariants (no cluster over its capacity, alive = accepted
               - overflow - departed, fleet fields the clusters' sums, the
               cascade admits every routed arrival and counts the rest as
               rejected by all), with one aggregate launch a refresh for
               the four clusters; steps/s, kernels a step and idle share
               (profiles of 12 and 24 steps, differenced). A batch of 24
               fleet runs for 600 steps (96 tables an aggregate launch):
               run 2018 equal to the run alone bit for bit. The aggregate
               at R = 4 and 96 tables of 4,096 slots against its plain
               version and R one-run launches (times, bound);
               ``paper_cascade``'s grid (~2,700 points) in chunks of 256
               against its plain version, each window of <= 256 points
               equal to a launch over it; a fleet refresh one CUDA kernel.
               The fleet engine ticked by ``make_fleet_run``'s generators
               for 600 ticks: its decisions and ``FleetMetrics`` equal
               ``make_fleet_run``'s bit for bit; ticks/s, decisions/s.

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
# phase 5 with 50 pseudo observations: every refresh's relative gap, card
# against CPU, must stay below these fixed limits, and a decision that
# differs must have its margin below the larger. Twice the largest gaps
# that phase read, E[L] 9.699e-4 and V[L] 1.015e-2 (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md), rounded up
PSEUDO_GAP_LIMIT = dict(el=2e-3, vl=2e-2)
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
ENGINE_SLO_MS = 50.0         # phase 11's deadline scheduler: decision SLO
MODES_STEPS = 720            # phase 4d's depth: 180 days of the 3 years


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
        run = make_run(cfg, grid, kind, record_decisions=True, device=DEVICE)
        policy = make_policy(kind, capacity=cfg.capacity, **kw)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m, accept = run(2018, policy)
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
                         steps_per_s=cfg.n_steps / wall, metrics=m,
                         accept=accept)
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


def pseudo_case(d, k, seed, device, runs=None):
    """``d`` arrivals (``runs`` x ``d`` for a batch) drawn from the priors
    on ``device``, their beliefs after ``k`` pseudo observations of their
    own processes and the request size (the §6 fold: mu_a >= k), their
    sizes, and alive flags."""
    import torch
    from repro_torch.core import (AZURE_PRIORS, apply_pseudo_observations,
                                  belief_from_prior, observe_initial_size,
                                  sample_params, sample_pseudo_observations)

    shape = (d,) if runs is None else (runs, d)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = sample_params(gen, AZURE_PRIORS, shape, device=device)
    c0 = 1.0 + torch.poisson(params.sig, generator=gen)
    obs = sample_pseudo_observations(gen, params, AZURE_PRIORS, k)
    bel = apply_pseudo_observations(
        belief_from_prior(AZURE_PRIORS, shape, device=device), obs,
        AZURE_PRIORS)
    alive = torch.rand(shape, generator=gen, device=device) < 0.6
    return observe_initial_size(bel, c0), c0, alive


def check_prior_inputs(records):
    """Phase 3, the §6/§7 inputs: both belief-form kernels against their
    plain versions on beliefs after 50 pseudo observations (the aggregate
    over 8,192 slots, one run and 24; the row kernel over 8 and 192 rows,
    PAPER_FULL's A and 24 A), and the row kernel on the unlabeled mode's
    2 A and 2 x 24 A rows, both components in one launch, bit for bit the
    two launches of one component each. Reports each case's largest
    relative error (where the plain value exceeds the tolerance's atol)."""
    import torch
    from repro_torch.core import AZURE_PRIORS, geometric_grid
    from repro_torch.core.belief import GammaBelief
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ops
    from repro_torch.kernels.moment_curves import ref as R

    n, nd = 48, 24
    t, idx, frac, _ = ops.curve_grid(
        geometric_grid(6.0, 78_840.0, n, device=DEVICE), nd)
    worst = {}

    def hold(name, got, want):
        rel = 0.0
        for g, w, tol in zip(got, want, (TOL_EL, TOL_VL)):
            torch.testing.assert_close(g, w, **tol)
            big = w.abs() > tol["atol"]
            rel = max(rel, float(((g - w).abs() / w.abs())[big].max()))
        worst[name] = max(worst.get(name, 0.0), rel)

    for runs in (None, 24):
        bel, _, alive = pseudo_case(8192, 50, 50 + (runs or 1), DEVICE, runs)
        cores = 1.0 + torch.poisson(torch.full(alive.shape, 5.0,
                                               device=DEVICE))
        args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
        hold("aggregate, 50 observations", K.moment_curves_agg_belief(*args),
             R.moment_curves_agg_belief_ref(*args))
    log(f"50 pseudo observations: mu_a {float(bel.mu_a.min()):.1f}-"
        f"{float(bel.mu_a.max()):.1f}, sig_a up to "
        f"{float(bel.sig_a.max()):.4g}")
    for rows in (8, 192):
        bel, c0, _ = pseudo_case(rows, 50, rows, DEVICE)
        args = (bel, c0, t, idx, frac, nd, AZURE_PRIORS)
        hold("rows, 50 observations", K.moment_curves_belief(*args),
             R.moment_curves_belief_ref(*args))
    for rows in (8, 192):
        bel, c0, _ = pseudo_case(rows, 5, 1000 + rows, DEVICE)
        alt, _, _ = pseudo_case(rows, 5, 2000 + rows, DEVICE)
        both = GammaBelief(*(torch.cat([x, y]) for x, y in zip(bel, alt)))
        args = (both, torch.cat([c0, c0]), t, idx, frac, nd, AZURE_PRIORS)
        one = K.moment_curves_belief(*args)
        hold("rows, unlabeled 2 A", one, R.moment_curves_belief_ref(*args))
        two = [K.moment_curves_belief(b, c0, t, idx, frac, nd, AZURE_PRIORS)
               for b in (bel, alt)]
        for i in range(2):
            if not torch.equal(one[i], torch.cat([two[0][i], two[1][i]])):
                raise AssertionError(f"the unlabeled launch of {2 * rows} "
                                     "rows differs from two launches")
    log("the §6/§7 inputs: kernels match their plain versions; largest "
        "relative error " + ", ".join(f"{k} {v:.3e}"
                                      for k, v in worst.items())
        + "; one launch of both components' rows equals two launches bit "
        "for bit (16 and 384 rows)")
    records["moment_curves_belief"]["prior_inputs_max_rel_err"] = {
        k: v for k, v in worst.items() if k.startswith("rows")}
    records["moment_curves_agg_belief"]["prior_inputs_max_rel_err"] = {
        k: v for k, v in worst.items() if k.startswith("aggregate")}


def modes_path(records):
    """Phase 4d: SECOND with Def. 4's heuristic at PAPER_FULL in the global
    prior mode (phase 4b's batch, with the heuristic: each mode at the same
    policy), the §6 (50 pseudo observations) and the §7 unlabeled (5 of
    each type) modes, each as one batch of 24 runs: one row-kernel launch a
    step (both mixture components' rows in one), one aggregate launch a
    refresh; run 0 equal to its run alone bit for bit."""
    import math

    import torch
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import make_run, split_seeds

    grid = geometric_grid(6.0, 3 * PAPER_FULL.horizon_hours, 48,
                          device=DEVICE)
    seeds = split_seeds(2018, 24)
    out = {}
    for mode, n_obs in (("global", 0), ("pseudo", 50), ("unlabeled", 5)):
        # cut to MODES_STEPS of the 4,380 steps (phase 12's room)
        cfg = PAPER_FULL._replace(agg_refresh_steps=12, prior_mode=mode,
                                  n_pseudo_obs=n_obs,
                                  horizon_hours=MODES_STEPS * PAPER_FULL.dt)
        run = make_run(cfg, grid, SECOND, device=DEVICE)
        policy = make_policy(SECOND, rho=PAPER_TABLE2["second_rho"],
                             capacity=cfg.capacity, marginal=True)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = run(seeds, policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        want.update(moment_curves_belief=cfg.n_steps,
                    moment_curves_agg_belief=cfg.n_steps
                    // cfg.agg_refresh_steps)
        if launches != want:
            raise AssertionError(f"{mode}: launches {launches}, want {want}")
        for field in m:
            if not bool(torch.isfinite(field).all()):
                raise AssertionError(f"{mode}: non-finite metrics")
        util = m.utilization.cpu()
        if not bool(((util > 0.0) & (util <= 1.0)).all()):
            raise AssertionError(f"{mode}: utilizations {util}")
        alone = run(seeds[0], policy)
        for name in alone._fields:
            if not torch.equal(getattr(m, name)[0], getattr(alone, name)):
                raise AssertionError(f"{mode}: run 0's {name} differs from "
                                     "its run alone")
        rate = len(seeds) * cfg.n_steps / wall
        if not math.isfinite(rate):
            raise AssertionError(f"{mode}: no rate")
        per_step = {k: v / cfg.n_steps for k, v in launches.items() if v}
        log(f"PAPER_FULL second (marginal), {mode} prior, {n_obs} "
            f"observations, a batch of {len(seeds)} runs: wall {wall:.2f} "
            f"s, {rate:.1f} runs x steps/s; moment-curve launches a step "
            f"{per_step}; utilization mean {float(util.mean()):.4f} (min "
            f"{float(util.min()):.4f}, max {float(util.max()):.4f}), "
            f"failure rate mean {float(m.failure_rate.mean()):.3e}; run 0 "
            "equals its run alone bit for bit")
        out[mode] = dict(runs_x_steps_per_s=rate, wall_s=wall,
                         launches=launches,
                         utilization=float(util.mean()))
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_prior_modes"] = {
            mode: o["launches"][name] for mode, o in out.items()}
    return out


def figures_quick():
    """Phase 4e: Fig. 1 and Fig. 2 (with §8's fees) at the quick preset
    through their drivers, each row beside the paper's number (not a gate):
    finite utilizations in (0, 1]."""
    import math

    from repro_torch.benchmarks import fig1_priors, fig2_pricing

    checked = []
    t0 = time.perf_counter()
    res = fig1_priors.results("quick", 0, DEVICE)
    checked += list(res.values())
    for row in fig1_priors.rows(res):
        log("  " + row)
    log(f"  (Fig. 1: {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res = fig2_pricing.results("quick", 0, DEVICE)
    checked += list(res.values())
    for row in fig2_pricing.rows(res, fig2_pricing.fees("quick", 0,
                                                        DEVICE)):
        log("  " + row)
    log(f"  (Fig. 2: {time.perf_counter() - t0:.1f} s)")
    for r in checked:
        if not (math.isfinite(r["utilization"])
                and 0.0 < r["utilization"] <= 1.0):
            raise AssertionError(f"a figure's row: utilization "
                                 f"{r['utilization']}")


def lockstep(prior_mode="global", n_obs=0):
    """Phase 5: a card core against a CPU core, step by step. In the
    global prior mode a decision that differs must be a float32 tie
    (margin below TIE_MARGIN); with pseudo observations the aggregate's gap
    grows with the posterior shape (ROADMAP.md Queue C): every refresh's
    gaps must stay below PSEUDO_GAP_LIMIT, and a decision that differs must
    have its margin below the larger limit. Returns the largest E[L] and V[L] gaps and
    the count of decisions whose margin lies inside their refresh's gap."""
    import torch
    from repro_torch.configs import PAPER_CPU
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.sim import draw_arrival_stream, make_admission_core
    from repro_torch.sim.core import tree_to
    from repro_torch.sim.simulator import (_accumulate_step, _run_metrics,
                                           _steps)

    cfg = PAPER_CPU._replace(agg_refresh_steps=4, prior_mode=prior_mode,
                             n_pseudo_obs=n_obs)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 24)
    devs = ("cpu", DEVICE)
    cores = {d: make_admission_core(cfg, grid, SECOND, device=d)
             for d in devs}
    policy = make_policy(SECOND, rho=0.112, capacity=cfg.capacity,
                         marginal=n_obs > 0)
    gen = torch.Generator().manual_seed(5)
    stream = draw_arrival_stream(gen, cfg)
    steps = {d: _steps(tree_to(stream, d)) for d in devs}
    rows = {d: _steps(cores[d].candidate_rows(tree_to(stream, d)))
            for d in devs}
    pols = {d: tree_to(policy, d) for d in devs}
    cs = {d: cores[d].init() for d in devs}
    traces = {d: ([], []) for d in devs}
    arange = {d: torch.arange(cfg.max_arrivals, device=d) for d in devs}
    limit = TIE_MARGIN if n_obs == 0 else max(PSEUDO_GAP_LIMIT.values())
    ties, inside, decisions = 0, 0, 0
    largest = dict(el=0.0, vl=0.0)
    for t in range(cfg.n_steps):
        if t % cfg.agg_refresh_steps == 0:
            for d in devs:
                cs[d] = cores[d].refresh_aggregates(cs[d])
            rel = lambda x, y: float(torch.nan_to_num(
                (x.cpu() - y).abs() / y.abs()).max())
            gaps = dict(el=rel(cs[DEVICE].agg_el, cs["cpu"].agg_el),
                        vl=rel(cs[DEVICE].agg_vl, cs["cpu"].agg_vl))
            largest = {k: max(v, gaps[k]) for k, v in largest.items()}
            gap = max(gaps.values())
            if n_obs and any(gaps[k] >= PSEUDO_GAP_LIMIT[k] for k in gaps):
                raise AssertionError(
                    f"step {t}: refreshed aggregate, card against CPU, "
                    f"E[L] gap {gaps['el']:.3e}, V[L] gap {gaps['vl']:.3e}: "
                    f"not below {PSEUDO_GAP_LIMIT}")
        ev = cores["cpu"].sample_events(gen, cs["cpu"].slots)
        acc, diag = {}, {}
        for d in devs:
            observed, out = cores[d].observe_events(cs[d], tree_to(ev, d))
            st = steps[d][t]
            valid = arange[d] < st.n_arrivals
            c, acc[d], diag[d] = cores[d].decide_batch_traced(
                pols[d], observed, out.util,
                cores[d].candidates(rows[d][t]), st, valid)
            n_acc = torch.sum(acc[d].float())
            n_rej = torch.sum(valid.float()) - n_acc
            slots, util_end = _accumulate_step(c.slots, out, n_acc, n_rej,
                                               cfg.dt)
            cs[d] = c._replace(slots=slots)
            traces[d][0].append(util_end)
            traces[d][1].append(out.failed)
        differ = acc["cpu"] != acc[DEVICE].cpu()
        cpu_margin = ((diag["cpu"].score - diag["cpu"].threshold).abs()
                      / diag["cpu"].threshold.abs())
        st_valid = steps["cpu"][t]
        valid_cpu = arange["cpu"] < st_valid.n_arrivals
        decisions += int(valid_cpu.sum())
        inside += int((valid_cpu & (cpu_margin < gap)).sum())
        if bool(differ.any()):
            margin = min(float(((dg.score.cpu() - dg.threshold.cpu()).abs()
                                / dg.threshold.cpu().abs())[differ].min())
                         for dg in diag.values())
            if margin >= limit:
                raise AssertionError(
                    f"step {t}: decisions differ at margin {margin:.3e} "
                    f"(limit {limit:.3e})")
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
    where = ("" if n_obs == 0
             else f", {prior_mode} prior, {n_obs} observations, marginal")
    gate = ("" if n_obs == 0 else
            f", every refresh's gaps below E[L] {PSEUDO_GAP_LIMIT['el']}, "
            f"V[L] {PSEUDO_GAP_LIMIT['vl']}")
    log(f"lockstep at PAPER_CPU ({cfg.n_steps} steps, {cfg.max_slots} "
        f"slots{where}): decisions equal, {ties} float32 ties (margin < "
        f"{limit}){gate}; refreshed aggregate, card vs CPU, largest "
        f"relative difference E[L] {largest['el']:.3e} (rows packed on "
        f"the host: {AGG_REL_HOST_PACKED:.3e}), V[L] {largest['vl']:.3e}; "
        f"{inside} of {decisions} decisions with a margin inside the gap "
        f"of E[L] and V[L] at their refresh; utilization "
        f"{float(metrics[DEVICE].utilization):.4f} on both")
    return dict(el_rel=largest["el"], vl_rel=largest["vl"], ties=ties,
                inside=inside, decisions=decisions)


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
    # a record_function range (the engine's ``annotate``) also shows as an
    # event on the device's timeline: not a kernel
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("repro.")]
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


def _percentile_ms(values, p):
    values = sorted(values)
    return 1e3 * values[min(len(values) - 1, int(p * len(values)))]


def engine_run(cfg, grid, policy, n_ticks, naive=False, timed=False,
               profile_at=None):
    """The online engine ticked with a generator seeded 2018 (phase 4's
    run's) for ``n_ticks``, deciding each window's arrivals of the stream
    drawn from it: through ``decide_slice`` (one 8-lane slice a tick), or
    on the naive lane through ``submit``/``flush`` (one request a
    decision). Returns the engine, its accept masks, its metrics, the wall
    time, with ``timed`` each flush's host seconds and device ms between
    CUDA events, and with ``profile_at`` ``profile_device``'s numbers of
    the 48 ticks from that tick on (left out of the flush times)."""
    import numpy as np
    import torch
    from repro_torch.bridge import to_numpy
    from repro_torch.core import SECOND
    from repro_torch.serve import Arrival, OnlineAdmissionEngine
    from repro_torch.sim import draw_arrival_stream
    from repro_torch.sim.simulator import _steps

    gen = torch.Generator(device=DEVICE).manual_seed(2018)
    stream = draw_arrival_stream(gen, cfg)
    host = to_numpy(stream)
    lanes = np.arange(cfg.max_arrivals)
    steps = _steps(stream)
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy,
                                micro_batch=8, naive=naive, device=DEVICE)
    stream_handle = torch.cuda.current_stream()
    accepts, host_s, events = [], [], []

    def one(t, timed):
        eng.tick(gen=gen)
        n = int(host.n_arrivals[t])
        if naive:
            futs = [eng.submit(Arrival.from_stream(host, t, a))
                    for a in range(n)]
            eng.flush()
            row = np.zeros(cfg.max_arrivals, bool)
            row[:n] = [f.result(timeout=60) for f in futs]
            accepts.append(row)
            return
        if not timed:
            accepts.append(eng.decide_slice(steps[t], lanes < n))
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream_handle)
        h0 = time.perf_counter()
        accepts.append(eng.decide_slice(steps[t], lanes < n))
        host_s.append(time.perf_counter() - h0)
        end.record(stream_handle)
        events.append((start, end))

    profiled = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = 0
    while t < n_ticks:
        if t == profile_at:
            window = range(t, t + 48)
            profiled = profile_device(lambda: [one(u, False) for u in window])
            t += len(window)
            continue
        one(t, timed)
        t += 1
    m = eng.metrics()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device_ms = [a.elapsed_time(b) for a, b in events]
    return eng, np.stack(accepts), m, wall, host_s, device_ms, profiled


def engine_path(records, single):
    """Phase 11: the online engine at PAPER_FULL, against phase 4's run."""
    import gc
    import queue
    import re
    import threading
    import urllib.request

    import numpy as np
    import torch
    from repro_torch.bridge import to_numpy
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, geometric_grid, make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.obs import MetricsServer, snapshot_to_prometheus
    from repro_torch.serve import Arrival, OnlineAdmissionEngine
    from repro_torch.sim import draw_arrival_stream

    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    grid = geometric_grid(cfg.dt, 3 * cfg.horizon_hours, 48, device=DEVICE)
    policy = make_policy(SECOND, rho=PAPER_TABLE2["second_rho"],
                         capacity=cfg.capacity)
    want = single["second"]
    want_accept = want["accept"].cpu().numpy()
    n_refresh = cfg.n_steps // cfg.agg_refresh_steps

    def check_equal(name, accept, m):
        if not np.array_equal(accept, want_accept):
            bad = np.argwhere(accept != want_accept)
            raise AssertionError(f"{name}: decisions differ from phase 4's "
                                 f"at (step, lane) {bad[:5].tolist()}")
        for field in m._fields:
            if not torch.equal(getattr(m, field),
                               getattr(want["metrics"], field)):
                raise AssertionError(f"{name}: {field} differs from phase "
                                     "4's")

    # 1. the engine through decide_slice, against phase 4's make_run
    n_objects, gen2 = len(gc.get_objects()), gc.get_stats()[2]["collections"]
    K.reset_launches()
    eng, accept, m, wall, host_s, device_ms, _ = engine_run(
        cfg, grid, policy, cfg.n_steps, timed=True)
    gen2 = gc.get_stats()[2]["collections"] - gen2
    launches = dict(K.LAUNCHES)
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update(moment_curves_agg_belief=n_refresh,
                         moment_curves_belief=cfg.n_steps)
    if launches != want_launches:
        raise AssertionError(f"engine: launches {launches}, want "
                             f"{want_launches}")
    check_equal("engine", accept, m)
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_engine"] = launches[name]
    rate = eng.decisions / wall
    log(f"engine at PAPER_FULL (decide_slice, micro-batch 8): {cfg.n_steps} "
        f"ticks in {wall:.2f} s, {cfg.n_steps / wall:.1f} ticks/s, "
        f"{eng.decisions} decisions, {rate:.1f} decisions/s (phase 4's "
        f"make_run: {want['steps_per_s']:.1f} steps/s); a flush: host "
        f"p50 {_percentile_ms(host_s, 0.5):.4f} ms, p99 "
        f"{_percentile_ms(host_s, 0.99):.4f} ms; device between CUDA events "
        f"p50 {statistics.median(device_ms):.4f} ms, p99 "
        f"{sorted(device_ms)[int(0.99 * len(device_ms))]:.4f} ms; launches "
        f"{launches}; decisions and metrics equal phase 4's bit for bit; "
        f"{n_objects:,} Python objects tracked at its start, {gen2} full "
        "collections during it")
    # 2. the same with the telemetry rider
    tel_cfg = cfg._replace(telemetry=True)
    eng_t, accept_t, m_t, wall_t, *_ = engine_run(tel_cfg, grid, policy,
                                                  cfg.n_steps)
    check_equal("engine with telemetry", accept_t, m_t)
    summary = eng_t.metrics_snapshot()["telemetry"]
    decided = (summary["n_admit"] + summary["n_reject_capacity"]
               + summary["n_reject_policy"])
    if not decided == summary["n_routed"] == eng_t.decisions:
        raise AssertionError(f"rider: {decided} admits + rejects, "
                             f"{summary['n_routed']} routed, "
                             f"{eng_t.decisions} decisions")
    if summary["n_windows"] != cfg.n_steps or \
            summary["n_refreshes"] != n_refresh:
        raise AssertionError(f"rider: {summary['n_windows']} windows, "
                             f"{summary['n_refreshes']} refreshes")
    short = {k: v for k, v in summary.items() if not isinstance(v, list)}
    short["staleness_hist"] = summary["staleness_hist"][:13]
    log(f"engine with telemetry: {cfg.n_steps / wall_t:.1f} ticks/s "
        f"({wall_t / wall:.3f}x the wall without); decisions and metrics "
        f"equal phase 4's bit for bit; rider {json.dumps(short)}")

    # 3. the naive lane: an aggregate recompute and a decision a request
    n_naive = 200
    K.reset_launches()
    eng_n, _, _, wall_n, *_ = engine_run(cfg, grid, policy, n_naive,
                                         naive=True)
    launches = dict(K.LAUNCHES)
    if not (launches["moment_curves_agg_belief"]
            == launches["moment_curves_belief"] == eng_n.decisions > 0):
        raise AssertionError(f"naive lane: launches {launches} for "
                             f"{eng_n.decisions} decisions")
    log(f"naive lane, {n_naive} ticks: {eng_n.decisions} decisions, "
        f"{eng_n.decisions / wall_n:.1f} decisions/s against "
        f"{rate:.1f} micro-batched ({rate / (eng_n.decisions / wall_n):.1f}x)"
        f"; launches {launches}")

    # 4. the deadline scheduler: a ticker and 4 submitters, then /metrics
    n_ticks, n_sub = 500, 4
    gen = torch.Generator(device=DEVICE).manual_seed(2018)
    stream = draw_arrival_stream(gen, tel_cfg)
    host = to_numpy(stream)
    eng_d = OnlineAdmissionEngine(tel_cfg, grid, SECOND, policy,
                                  micro_batch=8, flush_slo_ms=ENGINE_SLO_MS,
                                  device=DEVICE)
    inboxes = [queue.Queue() for _ in range(n_sub)]
    futures, errors = [], []

    def submitter(inbox):
        try:
            while (item := inbox.get()) is not None:
                futures.append(eng_d.submit(Arrival.from_stream(host, *item)))
        except Exception as exc:
            errors.append(exc)

    def ticker():
        try:
            for t in range(n_ticks):
                eng_d.tick(gen=gen)
                for a in range(int(host.n_arrivals[t])):
                    inboxes[a % n_sub].put((t, a))
        except Exception as exc:
            errors.append(exc)
        finally:
            for inbox in inboxes:
                inbox.put(None)

    threads = [threading.Thread(target=ticker)] + [
        threading.Thread(target=submitter, args=(q,)) for q in inboxes]
    eng_d.start()
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads) or errors:
        raise AssertionError(f"deadline scheduler: threads alive or errors "
                             f"{errors}")
    results = [f.result(timeout=60) for f in futures]
    wall_d = time.perf_counter() - t0
    eng_d.stop()
    want_n = int(host.n_arrivals[:n_ticks].sum())
    if len(results) != want_n or eng_d.decisions != want_n:
        raise AssertionError(f"deadline scheduler: {len(results)} futures, "
                             f"{eng_d.decisions} decisions, {want_n} sent")
    snap = eng_d.metrics_snapshot()
    e = snap["engine"]
    lat, batch = e["decision_latency_seconds"], e["flush_batch_size"]
    server = MetricsServer(
        lambda: snapshot_to_prometheus(eng_d.metrics_snapshot()), port=0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/metrics", timeout=30
        ).read().decode()
    finally:
        server.close()
    samples = {}
    for line in body.splitlines():
        if line.startswith("#"):
            continue
        m_line = re.fullmatch(r"([a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^{}]*\})?) "
                              r"(\S+)", line)
        if m_line is None:
            raise AssertionError(f"/metrics: malformed line {line!r}")
        samples[m_line.group(1)] = float(m_line.group(2).replace(
            "+Inf", "inf"))
    tel = snap["telemetry"]
    for name, value in (("repro_admission_admitted_total", tel["n_admit"]),
                        ("repro_admission_windows_total", tel["n_windows"]),
                        ("repro_admission_requests_total", want_n)):
        if samples.get(name) != value:
            raise AssertionError(f"/metrics: {name} {samples.get(name)}, "
                                 f"want {value}")
    log(f"deadline scheduler (SLO {ENGINE_SLO_MS:g} ms, 1 ticker + {n_sub} "
        f"submitters, {n_ticks} ticks): {want_n} futures resolved in "
        f"{wall_d:.2f} s ({want_n / wall_d:.1f} decisions/s), "
        f"{e['n_flushes']} flushes, mean batch "
        f"{batch.sum / max(batch.total, 1):.2f}, deadline misses "
        f"{e['deadline_misses']}, latency p50 "
        f"{1e3 * lat.percentile(0.5):.3f} ms, p99 "
        f"{1e3 * lat.percentile(0.99):.3f} ms against the SLO "
        f"{ENGINE_SLO_MS:g} ms; GET /metrics: {len(samples)} samples, "
        f"admitted {samples['repro_admission_admitted_total']:.0f} of "
        f"{want_n}")

    # 5. a profile of 48 ticks (tick + decide_slice), last: torch.profiler
    # runs after the timed items
    *_, profiled = engine_run(cfg, grid, policy, 300, profile_at=252)
    p_wall, p_busy, p_kernels, by_name = profiled
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"engine profile, ticks 252-299 (tick + decide_slice): "
        f"{p_kernels / 48:.2f} CUDA kernels a tick, host {p_wall / 48:.3f} "
        f"ms a tick (profiler on), device busy {p_busy / 48:.4f} ms a tick, "
        f"idle share {1 - p_busy / p_wall:.3f}; largest: "
        + ", ".join(f"{name[:48]} {ms / 48:.4f} ms" for name, ms in top))


# the JAX package's fleet benchmark (benchmarks/scenarios.py FLEET_FRACS):
# PAPER_FULL's capacity as a big, two mid and a small cluster, each with
# half the slots
FLEET_FRACS = (0.4, 0.3, 0.2, 0.1)
FLEET_ROUTER_STEPS = {"least_utilized": None, "power_of_two": None,
                      "random": 720, "cascade": 720}   # None: all 4,380
FLEET_BATCH_STEPS = 600      # phase 12's batch of 24 and its engine
FLEET_PROFILE_STEPS = 12     # profiles of 12 and 24 steps, differenced


def fleet_config(steps=None, capacities=None):
    """PAPER_FULL (K = 12) as a fleet: ``FLEET_FRACS`` of its capacity, each
    cluster with 4,096 slots (or ``capacities``, with all 8,192), cut to
    ``steps`` steps when given."""
    from repro_torch.configs import PAPER_FULL
    from repro_torch.sim import FleetConfig

    base = PAPER_FULL._replace(agg_refresh_steps=12)
    if capacities is None:
        capacities = tuple(round(f * PAPER_FULL.capacity, 1)
                           for f in FLEET_FRACS)
        base = base._replace(max_slots=PAPER_FULL.max_slots // 2)
    if steps is not None:
        base = base._replace(horizon_hours=steps * base.dt)
    return FleetConfig(base=base, capacities=capacities)


def check_fleet_invariants(name, fcfg, m, accept, assign, cascade=False):
    """tests/test_fleet.py's invariants on one fleet run: no cluster over its
    capacity, alive = accepted - overflow - departed, the fleet fields the
    reductions of ``per_cluster``, decisions only in the target cluster;
    under the cascade every routed arrival admitted and ``rejected_by_all``
    the valid arrivals routed nowhere."""
    import numpy as np
    import torch

    pc = m.per_cluster
    caps = np.asarray(fcfg.capacities, np.float32)
    peaks = pc.util_trace.cpu().numpy().max(axis=-1)
    if not (peaks <= caps + 1e-3).all():
        raise AssertionError(f"{name}: cluster peaks {peaks} over {caps}")
    if not torch.equal(pc.alive_end, pc.arrivals_accepted - pc.slot_overflow
                       - pc.n_departed):
        raise AssertionError(f"{name}: alive != accepted - overflow - "
                             "departed")
    total = lambda x: float(x.sum())
    for field in ("failed_requests", "total_requests", "arrivals_accepted",
                  "slot_overflow"):
        if float(getattr(m, field)) != total(getattr(pc, field)):
            raise AssertionError(f"{name}: {field} is not the clusters' sum")
    if float(m.arrivals_rejected) != total(pc.arrivals_rejected) + float(
            m.rejected_by_all):
        raise AssertionError(f"{name}: rejections not accounted for")
    util = float((pc.utilization.cpu().double() * torch.tensor(
        caps, dtype=torch.float64)).sum() / caps.sum())
    if not math.isclose(float(m.utilization), util, rel_tol=1e-5):
        raise AssertionError(f"{name}: utilization {float(m.utilization)} "
                             f"against the clusters' {util}")
    if not torch.allclose(m.util_trace, pc.util_trace.sum(dim=-2),
                          rtol=1e-6):
        raise AssertionError(f"{name}: util_trace is not the clusters' sum")
    acc, asg = accept.cpu().numpy(), assign.cpu().numpy()
    n_c = len(caps)
    routed = asg[..., None, :] == np.arange(n_c)[:, None]
    if (acc & ~routed).any():
        raise AssertionError(f"{name}: a cluster decided another's arrival")
    if cascade:
        if not np.array_equal(acc, routed):
            raise AssertionError(f"{name}: a routed arrival was refused")
        # the cascade sends the invalid lanes nowhere too
        n_valid = float(m.arrivals_accepted) + float(m.arrivals_rejected)
        if float(m.rejected_by_all) != float((asg == n_c).sum()) - (
                asg.size - n_valid):
            raise AssertionError(f"{name}: rejected_by_all miscounted")
    return float(m.rejected_by_all)


def fleet_step_profile(fcfg_of, router, policy):
    """(kernels a step, device busy ms a step, idle share, host ms a step)
    of fleet steps, from torch.profiler over runs of FLEET_PROFILE_STEPS
    and twice as many steps (their difference: the set-up cancels)."""
    from repro_torch.core import SECOND
    from repro_torch.sim import make_fleet_run

    out = {}
    for steps in (FLEET_PROFILE_STEPS, 2 * FLEET_PROFILE_STEPS):
        run = make_fleet_run(fcfg_of(steps), geometric_grid_full(), SECOND,
                             router=router, device=DEVICE)
        run(2018, policy)                      # warm
        out[steps] = profile_device(lambda: run(2018, policy))[:3]
    (w1, b1, k1), (w2, b2, k2) = out[FLEET_PROFILE_STEPS], out[
        2 * FLEET_PROFILE_STEPS]
    n = FLEET_PROFILE_STEPS
    return (k2 - k1) / n, (b2 - b1) / n, 1.0 - (b2 - b1) / (w2 - w1), \
        (w2 - w1) / n


def check_fleet_aggregate(records):
    """Phase 12, the aggregate as the fleet runs it: R = 4 and R = 96 slot
    tables of 4,096 slots (one fleet, a batch of 24 fleets) against the
    plain version and R one-run launches; ``paper_cascade``'s grid in
    chunks against the plain version and each chunk against launches over
    at most 256 points; one launch (one CUDA kernel) a fleet refresh."""
    import torch
    from repro_torch.core import AZURE_PRIORS, SECOND, paper_cascade
    from repro_torch.core.belief import GammaBelief
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.kernels.moment_curves import ops
    from repro_torch.kernels.moment_curves import ref as R
    from repro_torch.sim import make_admission_core

    d, n, nd = 4096, 48, 24
    rec = records["moment_curves_agg_belief"]
    rec["fleet"] = {}
    for runs in (4, 96):
        bel, cores, alive, _, (t, idx, frac, _) = belief_case(
            d, n, nd, 40 + runs, DEVICE, runs)
        args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
        singles = [(GammaBelief(*(x[r] for x in bel)), cores[r], alive[r],
                    t, idx, frac, nd, AZURE_PRIORS) for r in range(runs)]
        kern = lambda: K.moment_curves_agg_belief(*args)
        plain = lambda: R.moment_curves_agg_belief_ref(*args)
        el, vl = kern()
        want_el, want_vl = plain()
        torch.testing.assert_close(el, want_el, **TOL_EL)
        torch.testing.assert_close(vl, want_vl, **TOL_VL)
        for r, one_args in enumerate(singles):
            one = K.moment_curves_agg_belief(*one_args)
            if not (torch.equal(one[0], el[r]) and torch.equal(one[1],
                                                               vl[r])):
                raise AssertionError(f"fleet aggregate R={runs}: table {r} "
                                     "differs from its one-run launch")
        b_ms, b_by = bound_runs(runs, d, n, nd)
        timed = dict(
            ms=event_ms(kern), device_ms=graph_ms(kern, reps=20),
            one_run_launches_device_ms=graph_ms(
                lambda: [K.moment_curves_agg_belief(*a) for a in singles],
                reps=max(2, 192 // runs)),
            plain_ms=event_ms(plain, reps=10, warm=2), bound_ms=b_ms,
            bound_by=b_by,
            max_abs_err=max(float((el - want_el).abs().max()),
                            float((vl - want_vl).abs().max())),
            shape=dict(R=runs, D=d, N=n, ND=nd))
        rec["fleet"][f"R={runs}"] = timed
        log(f"fleet aggregate, R={runs} tables of D={d} (N={n}): "
            f"{timed['ms']:.4f} ms a call ({timed['device_ms']:.4f} ms on "
            f"the device; {runs} one-run launches "
            f"{timed['one_run_launches_device_ms']:.4f}), plain "
            f"{timed['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by}), max "
            f"abs err {timed['max_abs_err']:.3e}; equal to one-run launches "
            "bit for bit")
        del want_el, want_vl

    # paper_cascade's grid, in chunks of 256
    grid = paper_cascade(device=DEVICE)
    n_c = grid.shape[0]
    chunks = K.agg_chunks(n_c)
    bel, cores, alive, _, _ = belief_case(d, 12, nd, 77, DEVICE)
    t, idx, frac, _ = ops.curve_grid(grid, nd)
    args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
    before = K.LAUNCHES["moment_curves_agg_belief"]
    el, vl = K.moment_curves_agg_belief(*args)
    if K.LAUNCHES["moment_curves_agg_belief"] - before != len(chunks):
        raise AssertionError("chunked aggregate: not one launch a chunk")
    want_el, want_vl = R.moment_curves_agg_belief_ref(*args)
    torch.testing.assert_close(el, want_el, **TOL_EL)
    torch.testing.assert_close(vl, want_vl, **TOL_VL)
    used = max(tolerance_used(el, want_el, TOL_EL),
               tolerance_used(vl, want_vl, TOL_VL))
    windows = [(0, 1), (0, 256), (200, 300), (250, 256), (1000, 1150),
               (n_c - 256, n_c), (n_c - 7, n_c)]
    windows += [(a, b) for a, b in chunks]
    for a, b in windows:
        part = K._agg_belief_launch(bel, cores, alive, t[a:b], idx[a:b],
                                    frac[a:b], t, nd, AZURE_PRIORS)
        if not (torch.equal(part[0], el[a:b]) and torch.equal(part[1],
                                                              vl[a:b])):
            raise AssertionError(f"chunked aggregate: points [{a}, {b}) "
                                 "differ from a launch over them")
    residency = {m: K.agg_residency(True, m)["ctas_per_sm"]
                 for m in sorted({48, 256, chunks[-1][1] - chunks[-1][0]})}
    kern = lambda: K.moment_curves_agg_belief(*args)
    plain = lambda: R.moment_curves_agg_belief_ref(*args)
    b_ms, b_by = bound_runs(1, d, n_c, nd)
    timed = dict(ms=event_ms(kern, reps=20), device_ms=graph_ms(kern, reps=5),
                 plain_ms=event_ms(plain, reps=5, warm=1), bound_ms=b_ms,
                 bound_by=b_by, launches_a_call=len(chunks),
                 max_abs_err=max(float((el - want_el).abs().max()),
                                 float((vl - want_vl).abs().max())),
                 shape=dict(R=1, D=d, N=n_c, ND=nd))
    rec["fleet"]["paper_cascade"] = timed
    log(f"chunked aggregate at paper_cascade's N={n_c} (D={d}): "
        f"{len(chunks)} launches a call, matches its plain version (largest "
        f"share of the tolerance used {used:.3e}, max abs err "
        f"{timed['max_abs_err']:.3e}); {len(windows)} windows of <= 256 "
        f"points equal bit for bit to launches over them; CTAs an SM by N "
        f"{residency}; {timed['ms']:.4f} ms a call ({timed['device_ms']:.4f} "
        f"ms on the device), plain {timed['plain_ms']:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by})")
    del want_el, want_vl

    # one launch a fleet refresh: a fleet's 4 tables, a batch's 96
    fcfg = fleet_config()
    core = make_admission_core(fcfg.base, geometric_grid_full(), SECOND,
                               device=DEVICE)
    for lead in ((4,), (24, 4)):
        runs = math.prod(lead)
        bel, cores, alive, _, _ = belief_case(d, n, nd, 90 + runs, DEVICE,
                                              runs)
        cs = core.init(lead)
        view = lambda x: x.view(*lead, d)
        cs = cs._replace(slots=cs.slots._replace(
            bel=GammaBelief(*map(view, bel)), cores=view(cores),
            alive=view(alive)))
        names = kernels_of_one_call(lambda: core.refresh_aggregates(cs))
        if len(names) != 1 or "agg_kernel" not in names[0]:
            raise AssertionError(f"a fleet refresh of {lead} tables ran "
                                 f"{names}")
    log("a fleet refresh is one CUDA kernel in a CUDA graph of it, for 4 "
        "tables (one fleet) and 96 (a batch of 24 fleets)")


def geometric_grid_full():
    from repro_torch.core import geometric_grid

    return geometric_grid(6.0, 3 * 3 * 365 * 24.0, 48, device=DEVICE)


def fleet_path(records, single):
    """Phase 12: the routed fleet at PAPER_FULL (make_fleet_run, the four
    routers, a batch of 24 fleet runs, the aggregate as the fleet runs it,
    the fleet engine)."""
    import numpy as np
    import torch
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, fleet_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.serve import OnlineAdmissionEngine
    from repro_torch.sim import (ROUTERS, draw_arrival_stream, make_fleet_run,
                                 split_seeds, stream_config)
    from repro_torch.sim.simulator import _steps

    rho = PAPER_TABLE2["second_rho"]
    grid = geometric_grid_full()
    launches_fleet = {}

    def launches_of(name, n_steps):
        got = dict(K.LAUNCHES)
        want = dict.fromkeys(got, 0)
        want.update(moment_curves_belief=n_steps,
                    moment_curves_agg_belief=n_steps // 12)
        if got != want:
            raise AssertionError(f"{name}: launches {got}, want {want}")
        launches_fleet[name] = got

    # 1. a fleet of one is make_run: phase 4's decisions, bit for bit
    one = fleet_config(capacities=(PAPER_FULL.capacity,))
    run = make_fleet_run(one, grid, SECOND, record_decisions=True,
                         device=DEVICE)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    m, accept, _ = run(2018, fleet_policy(SECOND, capacities=one.capacities,
                                          rho=rho))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_of("fleet of one", one.base.n_steps)
    want = single["second"]
    if not torch.equal(accept[:, 0], want["accept"]):
        raise AssertionError("fleet of one: decisions differ from phase 4's")
    for field in want["metrics"]._fields:
        got = getattr(m.per_cluster, field)
        got = got[..., 0, :] if got.ndim > 1 else got[0]
        if not torch.equal(got, getattr(want["metrics"], field)):
            raise AssertionError(f"fleet of one: {field} differs from "
                                 "phase 4's")
    log(f"fleet of one at PAPER_FULL: {one.base.n_steps / wall:.1f} steps/s "
        f"(phase 4's make_run {want['steps_per_s']:.1f}); decisions "
        "[T, 1, A] and metrics equal phase 4's bit for bit")

    # 2. the four routers on the four-cluster fleet
    caps = fleet_config().capacities
    policy = fleet_policy(SECOND, capacities=caps, rho=rho)
    runs = {}
    for name in ("least_utilized", "power_of_two", "random", "cascade"):
        fcfg = fleet_config(FLEET_ROUTER_STEPS[name])
        router = ROUTERS[name]()
        run = make_fleet_run(fcfg, grid, SECOND, router=router,
                             record_decisions=True, device=DEVICE)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m, accept, assign = run(2018, policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_steps = fcfg.base.n_steps
        launches_of(name, n_steps)
        for field in m:
            if not all(bool(torch.isfinite(x).all()) for x in
                       (field if isinstance(field, tuple) else (field,))):
                raise AssertionError(f"{name}: non-finite metrics")
        rej_all = check_fleet_invariants(name, fcfg, m, accept, assign,
                                         cascade=name == "cascade")
        kernels, busy, idle, host_ms = fleet_step_profile(
            lambda s: fleet_config(s), router, policy)
        util = m.per_cluster.utilization.cpu().numpy()
        runs[name] = dict(steps=n_steps, steps_per_s=n_steps / wall,
                          kernels_a_step=kernels, busy_ms_a_step=busy,
                          idle_share=idle, host_ms_a_step=host_ms,
                          utilization=float(m.utilization),
                          cluster_utilization=util.tolist(),
                          failure_rate=float(m.failure_rate),
                          rejected_by_all=rej_all,
                          launches=launches_fleet[name])
        log(f"fleet, {name}, {len(caps)} clusters {caps}, {n_steps} steps: "
            f"{n_steps / wall:.1f} steps/s; {kernels:.2f} CUDA kernels a "
            f"step, device busy {busy:.4f} ms a step, idle share "
            f"{idle:.3f} (profiler on, {host_ms:.3f} ms a step); "
            f"utilization {float(m.utilization):.4f} (clusters "
            f"{np.round(util, 4).tolist()}), failure rate "
            f"{float(m.failure_rate):.3e}, rejected by all {rej_all:.0f}; "
            f"aggregate launches {launches_fleet[name]['moment_curves_agg_belief']}"
            f" (one a refresh for the {len(caps)} clusters), row launches "
            f"{launches_fleet[name]['moment_curves_belief']}; invariants hold")

    # 3. a batch of 24 fleet runs (96 tables an aggregate launch)
    fcfg = fleet_config(FLEET_BATCH_STEPS)
    run = make_fleet_run(fcfg, grid, SECOND, record_decisions=True,
                         device=DEVICE)
    seeds = split_seeds(2018, 23)
    seeds.insert(5, 2018)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    mb, accb, asgb = run(seeds, policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_of("batch of 24", FLEET_BATCH_STEPS)
    alone = run(2018, policy)
    for field in alone[0]._fields:
        got, ref = getattr(mb, field), getattr(alone[0], field)
        pairs = zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]
        for g, r in pairs:
            if not torch.equal(g[5], r):
                raise AssertionError(f"fleet batch run 2018: {field} "
                                     "differs from the run alone")
    if not (torch.equal(accb[5], alone[1]) and torch.equal(asgb[5],
                                                           alone[2])):
        raise AssertionError("fleet batch run 2018: decisions differ")
    rate = len(seeds) * FLEET_BATCH_STEPS / wall
    log(f"a batch of {len(seeds)} fleet runs, {FLEET_BATCH_STEPS} steps: "
        f"{wall:.2f} s, {rate:.1f} runs x steps/s ({FLEET_BATCH_STEPS / wall:.1f}"
        f" batched steps/s); aggregate launches "
        f"{launches_fleet['batch of 24']['moment_curves_agg_belief']} (each "
        f"over {len(seeds) * len(caps)} tables); run 2018 equals the fleet "
        f"run alone bit for bit over {FLEET_BATCH_STEPS} steps")

    # 4. the aggregate as the fleet runs it
    check_fleet_aggregate(records)

    # 5. the fleet engine ticked by make_fleet_run's generators
    gen = torch.Generator(device=DEVICE).manual_seed(2018)
    stream = draw_arrival_stream(gen, stream_config(fcfg))
    eng = OnlineAdmissionEngine(fcfg, grid, SECOND, policy, micro_batch=8,
                                device=DEVICE)
    lanes = np.arange(fcfg.base.max_arrivals)
    n_arr = stream.n_arrivals.cpu().numpy()
    accepts = []
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    for t, slice_t in enumerate(_steps(stream)):
        eng.tick(gen=gen)
        accepts.append(eng.decide_slice(slice_t, lanes < n_arr[t]))
    me = eng.metrics()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_of("engine", FLEET_BATCH_STEPS)
    if not np.array_equal(np.stack(accepts),
                          alone[1].cpu().numpy().any(axis=1)):
        raise AssertionError("fleet engine: decisions differ from "
                             "make_fleet_run's")
    for field in me._fields:
        got, ref = getattr(me, field), getattr(alone[0], field)
        pairs = zip(got, ref) if isinstance(ref, tuple) else [(got, ref)]
        if not all(torch.equal(g, r) for g, r in pairs):
            raise AssertionError(f"fleet engine: {field} differs from "
                                 "make_fleet_run's")
    log(f"fleet engine ({len(caps)} clusters, least utilized, micro-batch 8, "
        f"decide_slice) for {FLEET_BATCH_STEPS} ticks: "
        f"{FLEET_BATCH_STEPS / wall:.1f} ticks/s, {eng.decisions} decisions, "
        f"{eng.decisions / wall:.1f} decisions/s; decisions and FleetMetrics "
        "equal make_fleet_run's bit for bit")
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_fleet"] = {
            k: v[name] for k, v in launches_fleet.items()}
    records["moment_curves_agg_belief"]["fleet_runs"] = runs


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
        check_prior_inputs(records)

    with phase("4. main path at PAPER_FULL"):
        single = main_path(records)

    with phase("4b. a batch of 24 runs at PAPER_FULL"):
        batch_path(records, single)

    with phase("4c. Table 2 at the quick preset"):
        table2_quick()

    with phase("4d. the prior modes at PAPER_FULL, batches of 24 runs"):
        modes_path(records)

    with phase("4e. Fig. 1 and Fig. 2 at quick"):
        figures_quick()

    with phase("5. card against CPU, in lockstep"):
        lockstep()
        lockstep("pseudo", 50)

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

    with phase("11. online engine at PAPER_FULL"):
        engine_path(records, single)

    with phase("12. the routed fleet at PAPER_FULL"):
        fleet_path(records, single)

    log(card)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
