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
               launches) and no packed one. Then SECOND for its first 480
               steps (``SHORT_STEPS``), the reference of the runs that
               phases 4b, 11 and 12 cut to that depth.
  4b. batch  — the same SECOND run (480 steps) as one batch of 24 seeds,
               2018 among them: 480 candidate launches (each the batch's
               24 x 8 rows) and 40 aggregate launches for the whole batch
               (each over all 24 runs); run 2018 equal to phase 4's bit
               for bit; runs x steps/s beside phase 4's steps/s.
  4c. Table 2 — ``repro_torch.benchmarks.common.tune_and_eval`` at the
               ``quick`` preset for ZEROTH, FIRST and SECOND: theta,
               utilization with its BCa interval, SLA rate, stages,
               simulations and seconds, beside the JAX package's
               ``tuning/calibrate/*`` rows of BENCH_quick.json; every chosen
               theta feasible under the port's own measurement.
  4d. modes  — SECOND with Def. 4's heuristic at PAPER_FULL cut to 120
               days (480 of its 4,380 steps)
               in the GLOBAL, §6 PSEUDO (50 observations) and §7 unlabeled
               (5 of each type) modes, each a batch of 24 runs: one
               row-kernel launch a step (both mixture components' rows in
               it) and one aggregate a refresh; run 0 equal to its run
               alone bit for bit; runs x steps/s, launches a step,
               utilization.
  4e. figures — ``repro_torch.benchmarks`` ``fig1_priors`` at the
               ``tiny`` preset (``quick`` before PR 23) and
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
               between CUDA events. Again with the telemetry rider for 480
               ticks (phase 4's 480-step run's bits; admits + rejects =
               decisions). The naive lane for 200
               ticks (one aggregate launch a request). The deadline
               scheduler (SLO 50 ms) fed by a ticker thread and 4 submitter
               threads for the stream's 480 ticks: every future
               resolves; misses and
               latency p50/p99 against the SLO; one ``GET /metrics`` from
               an ephemeral port, parsed, carrying the rider's counters.
               Last, a profile of 48 ticks (kernels a tick, idle share).
 12. fleet   — ``make_fleet_run`` at PAPER_FULL split as the JAX package's
               fleet benchmark splits it: 8,000 / 6,000 / 4,000 / 2,000
               cores, 4,096 slots each, SECOND rho 0.112 through
               ``fleet_policy``. A fleet of one (all 20,000 cores, 8,192
               slots) takes phase 4's decisions bit for bit over 480 steps.
               Each router (for 480 steps) holds tests/test_fleet.py's
               invariants (no cluster over its capacity, alive = accepted
               - overflow - departed, fleet fields the clusters' sums, the
               cascade admits every routed arrival and counts the rest as
               rejected by all), with one aggregate launch a refresh for
               the four clusters; steps/s, kernels a step and idle share
               (profiles of 12 and 24 steps, differenced). A batch of 24
               fleet runs for 360 steps (96 tables an aggregate launch):
               run 2018 equal to the run alone bit for bit. The aggregate
               at R = 4 and 96 tables of 4,096 slots against its plain
               version and R one-run launches (times, bound);
               ``paper_cascade``'s grid (~2,700 points) in chunks of 256
               against its plain version, each window of <= 256 points
               equal to a launch over it; a fleet refresh one CUDA kernel.
               The fleet engine ticked by ``make_fleet_run``'s generators
               for 360 ticks: its decisions and ``FleetMetrics`` equal
               ``make_fleet_run``'s bit for bit; ticks/s, decisions/s.

 13. traces  — the trace-driven path: every scenario synthesized at
               TRACE_FULL (3 years, 1 arrival/h, 65,536 rows, 32 events)
               on the card and validated, the baseline's latent and
               observed fits within tests/test_traces.py's tolerances; the
               Azure sample ingested, fitted (observed) and replayed in a
               short run; the baseline replayed through ``make_run`` at
               PAPER_FULL with 16 arrivals a step for its first 480 steps
               (480 row and 40 aggregate launches;
               its GLOBAL stream built on the card
               equal to the CPU's bit for bit); ``replay_stream_batch`` of
               24 traces through ``run_keyed_batch`` for their first 480
               steps; ``make_importance_plan``
               at PAPER_FULL (512 probes in batches of 64, quotas 8/8/8;
               probe seconds, peak device memory), ``simulate_plan`` and
               ``estimate_from_plan`` (a selected seed's probe stream equal
               to its run's bit for bit); ``make_trace_ensemble_plan`` over
               32 replays of 480 steps and ``simulate_trace_plan``;
               ``calibrate_scenario``
               (flash crowd, SECOND at rho 0.112) and ``run_drift_protocol``
               (drift step, ``drift_bench``'s ``quick``) at ``quick``; the
               fleet replay row at the fleet split for 480 steps; the engine
               with telemetry and a ``DriftDetector`` for 360 ticks, scraped
               every 36 (the first scrape, from an empty cluster, warm-up),
               its null calibrated on 3 stationary replays of the same
               engine and windows, its snapshots' ``"drift"`` equal to a
               detector fed the scrapes' observable deltas.
 14. drivers — ``repro_torch.benchmarks``' ``tuning_bench`` and
               ``serve_bench`` at their ``smoke`` preset, written through
               ``run.py``'s writer into one BENCH file (the serve run
               serving at the tuning run's thetas); ``pick_agg_refresh``
               reads back the ``tuning/pick_agg_refresh/smoke`` row's K and
               ``load_operating_point`` each ``tuning/calibrate/<kind>``
               theta; ``kernels_bench`` with each CUDA row's output held
               against its plain row's (phases 3 and 7's tolerances);
               ``run.main --only kernels`` twice into one file (no name
               twice); each of ``repro_torch.examples``' six modules with
               ``--smoke`` as ``python -m`` runs it (exit, no NaN or
               infinity printed, Prop. 4's line). Every path's moment-curve
               kernels (and the kernels row's flash kernel) must launch.
 15. families — the nine other architectures at their published widths
               (every d_model, head count, KV-head count, head_dim, d_ff,
               vocab, expert count, top-k, SSM state and window of the
               config), bf16 weights from a generator on the card; depth
               cut only where the weights do not fit (60 GB of bf16
               weights at once: dbrx-132b runs 8 of its 40 layers,
               chameleon-34b 41 of 48; each cut printed with its reason),
               the other seven whole. First the two attention
               kernels at the shapes the families bring (flash at (G, Dh)
               = (5, 64) with window 2,048, (5, 128), (6, 128), (12, 128)
               and (48, 128); decode at G = 5, 6, 12, 48 and on hymba's
               rolling buffer past its window) against their plain
               versions with phase 7's tolerances, each timed beside SDPA.
               Then each architecture: ``forward`` (B = 2, S = 2,048;
               hymba 2,688; whisper 1,500 frames and 448 tokens) with the
               flash lane on and off (the rms gap of the logits, the share
               of equal argmax; each layer's attention held to phase 8's
               limit); ``prefill`` (hymba 2,560 tokens, past its window)
               and 8 teacher-forced ``decode_step``s with the decode kernel
               on and off against the forward's logits at the same
               positions (for MoE the two decode lanes against each
               other, at the per-layer limit); for MoE two forwards
               bit-equal and layer 0's dropped fraction at T = 4,096 and
               at a B = 4 decode step (capacity 1); two requests served
               through ``launch.serve``'s engine. Last, ``launch.serve
               --arch hymba-1.5b`` at full depth, 8 requests of 32 new tokens
               (tokens/s), and ``python -m repro_torch.examples.serve_lm
               --smoke``. Both attention kernels must launch on the model
               paths (counted from 0 around each).
 16. training — llama3.2-1b trained at full width through
               ``launch.train.train`` at the launcher's defaults (B 8, S
               128, float32 state, bf16 compute, remat, the einsum lane),
               20 steps: loss finite (it starts at ln V on the launcher's
               near-uniform synthetic tokens and cannot fall in 20 steps),
               ms a step, tokens/s, peak memory; the final 14.8 GB
               checkpoint (512 MiB shards, in a ``tempfile.mkdtemp()``
               directory whose free space is checked first) timed and
               restored to the card bit for bit. One launcher step
               profiled, then 8 steps on one batch, whose loss must fall
               by 1 nat. Then 3
               steps at B 4, S 2,048 (tokens/s, 6 N tokens / step time
               against 989 TFLOP/s bf16, peak memory), 3 with microbatches
               2 and 3 with compression; the trained weights' forward (B 2,
               S 2,048) with the flash lane on and off without grad (phase
               8's checks; flash launches counted from 0), and the flash
               kernel refused under grad. Then reduced llama3.2-1b through
               ``launch.train`` with a failure mid-run against an
               uninterrupted run (the largest parameter gap), ``python -m
               repro_torch.examples.train_lm --smoke``, and one train step
               of a reduced config of each family (dense, moe, hybrid, ssm,
               audio) on the card against the CPU.
 17. mesh    — the admission system's mesh with
               ``REPRO_TORCH_DEVICE_COUNT=4`` (4 logical devices on the
               card, set and restored in the phase): the online engine at
               PAPER_FULL's 8,192 slots (SECOND rho 0.112, the fused lane
               the sharded refresh mirrors, micro-batch 8, the rider on,
               360 ticks) with ``shards=4`` against ``shards=1``: decisions,
               every refreshed aggregate, metrics and rider with gap 0;
               ticks/s, decisions/s, kernels a tick and a flush's host ms
               p50/p99 of both. Phase 4b's seeds, 24 runs and then a ragged
               22, 120 steps, split over the 4 against one device; ``calibrate`` at ``smoke`` over 4 devices
               against 1; a 64-probe ``make_importance_plan`` at PAPER_FULL
               over 4 against 1 (equal BM); whether cuBLAS gives a row of
               the fused lane's old interpolation matmul the same bits at
               every row count. Phase 14's ``serve_bench`` carries the
               ``sharded`` row (8 logical devices).
 18. LM mesh — the LM scaffold with ``REPRO_TORCH_DEVICE_COUNT=4`` (set and
               restored in the phase): llama3.2-1b at full width and depth
               through ``ServeEngine(mesh=make_host_mesh())`` (1, 4), 4
               requests, against the unsharded engine, the sharded one
               following its tokens: float32 tokens equal and logits at
               1e-4, bf16 the rms gap and the share of equal argmax;
               ``decode_step(use_kernel=True)`` at full width over a
               4,096-slot bf16 cache sharded along its sequence (2,048
               filled, 8 steps, float32 activations) against the unsharded
               kernel lane at 1e-4, the decode kernel's log-sum-exp form
               launched once a shard a layer a step (counted from 0);
               that form against its plain version and timed beside the
               form without it (the ``decode_gqa_lse`` entry);
               moonshot-v1-16b-a3b at full width (64 experts, 16 a model
               rank), depth cut to 4 of 48 layers, float32, with
               ``moe_local_dispatch``: the forward at capacity factor 8
               against the global dispatch's at 1e-4 and layer 0's dropped
               fraction at 1.25; llama3.2-1b trained 3 steps at B 8, S 128
               over (2, 2) against one device (loss at 2e-4, ms a step,
               peak memory); the GPipe pipeline on 4 stages against the
               sequential stack; a reduced train state restored onto
               (1, 4), (4, 1) and (2, 2) bit for bit.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
import copy
import dataclasses
import json
import math
import re
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
MODES_STEPS = 480            # phase 4d's depth: 120 days of the 3 years
# the depth of phase 4b's batch, phase 11's engine with telemetry and phase
# 12's fleet of one and routers, cut from the 4,380 steps of PAPER_FULL to
# keep the whole script inside its time limit on a slow host; phase 4 runs
# SECOND at this depth too, as their reference
SHORT_STEPS = 480
# phase 17: the mesh on one card, as logical devices
MESH_SHARDS = 4
# the engine's ticks and the split batches' steps (the phase took 102 s
# at 720 ticks and steps)
MESH_TICKS = 360
MESH_BATCH_STEPS = 120
MESH_BATCHES = (24, 22)      # runs of the split batches (22: ragged)
MESH_PROBES = 64
MESH_PROFILE = 24            # ticks of each engine's profile


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
    # SECOND cut to SHORT_STEPS: the reference of the phases cut to it
    short = short_config()
    run = make_run(short, grid, SECOND, record_decisions=True, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, accept = run(2018, make_policy(SECOND, capacity=cfg.capacity,
                                      rho=PAPER_TABLE2["second_rho"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["second_short"] = dict(metrics=m, accept=accept,
                               steps_per_s=short.n_steps / wall)
    log(f"PAPER_FULL second, the first {short.n_steps} steps (the reference "
        f"of phases 4b, 11, 12 and 13's runs at that depth): utilization "
        f"{float(m.utilization):.4f}, {short.n_steps / wall:.1f} steps/s")
    return out


def short_config():
    """PAPER_FULL (K = 12) cut to its first SHORT_STEPS steps."""
    from repro_torch.configs import PAPER_FULL

    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    return cfg._replace(horizon_hours=SHORT_STEPS * cfg.dt)



def batch_path(records, single):
    """Phase 4b: phase 4's SECOND run, cut to SHORT_STEPS, as one batch of
    24 seeds."""
    import math

    import torch
    from repro_torch.configs import PAPER_TABLE2
    from repro_torch.core import SECOND, make_policy
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import make_run, split_seeds

    cfg = short_config()
    grid = geometric_grid_full()
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
    alone = single["second_short"]["metrics"]
    for name in alone._fields:
        if not torch.equal(getattr(m, name)[5], getattr(alone, name)):
            raise AssertionError(f"batch run 2018: {name} differs from "
                                 "phase 4's run")
    rate = len(seeds) * cfg.n_steps / wall
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_batch"] = launches[name]
    one = single["second_short"]["steps_per_s"]
    log(f"PAPER_FULL second, the first {cfg.n_steps} steps (cut from "
        f"4,380), a batch of {len(seeds)} runs: wall "
        f"{wall:.2f} s, {cfg.n_steps / wall:.1f} batched steps/s, "
        f"{rate:.1f} runs x steps/s (phase 4, one run: "
        f"{one:.1f} steps/s; {rate / one:.2f}x); utilization "
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
    """Phase 4e: Fig. 1 at the tiny preset and Fig. 2 (with §8's fees) at
    the quick preset through their drivers, each row beside the paper's number (not a gate):
    finite utilizations in (0, 1]."""
    import math

    from repro_torch.benchmarks import fig1_priors, fig2_pricing

    checked = []
    t0 = time.perf_counter()
    # Fig. 1 at the tiny preset since PR 23 (it took 85-123 s at quick)
    res = fig1_priors.results("tiny", 0, DEVICE)
    checked += list(res.values())
    for row in fig1_priors.rows(res):
        log("  " + row)
    log(f"  (Fig. 1 at tiny: {time.perf_counter() - t0:.1f} s)")
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


def sdpa(q, k, v, causal, mask=None):
    """One PyTorch call for the same attention ([B, S, H, Dh] inputs), the
    yardstick ``library_ms``; the port never calls it. ``mask``: an [Sq,
    Sk] bool of visible keys, in place of ``causal`` (a sliding window)."""
    import torch.nn.functional as F

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    return F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)


def sdpa_window(q, k, v, window):
    """``sdpa`` of causal attention in a window of ``window`` keys, as one
    call: plain causal where the window covers every key, else a banded
    mask (built here, before the call that is timed)."""
    from repro_torch.kernels.flash_attention import ref as FR

    s = q.shape[1]
    if not window or window >= s:
        return lambda: sdpa(q, k, v, True)
    band = FR.attention_mask(s, s, True, window, q.device)
    return lambda: sdpa(q, k, v, False, band)


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
    n_refresh = cfg.n_steps // cfg.agg_refresh_steps

    def check_equal(name, accept, m, want=want):
        want_accept = want["accept"].cpu().numpy()
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
    # 2. the same with the telemetry rider, cut to SHORT_STEPS ticks
    tel_cfg = short_config()._replace(telemetry=True)
    eng_t, accept_t, m_t, wall_t, *_ = engine_run(tel_cfg, grid, policy,
                                                  tel_cfg.n_steps)
    check_equal("engine with telemetry", accept_t, m_t,
                single["second_short"])
    summary = eng_t.metrics_snapshot()["telemetry"]
    decided = (summary["n_admit"] + summary["n_reject_capacity"]
               + summary["n_reject_policy"])
    if not decided == summary["n_routed"] == eng_t.decisions:
        raise AssertionError(f"rider: {decided} admits + rejects, "
                             f"{summary['n_routed']} routed, "
                             f"{eng_t.decisions} decisions")
    if summary["n_windows"] != tel_cfg.n_steps or \
            summary["n_refreshes"] != tel_cfg.n_steps // 12:
        raise AssertionError(f"rider: {summary['n_windows']} windows, "
                             f"{summary['n_refreshes']} refreshes")
    short = {k: v for k, v in summary.items() if not isinstance(v, list)}
    short["staleness_hist"] = summary["staleness_hist"][:13]
    tick_s = wall / cfg.n_steps
    log(f"engine with telemetry, the first {tel_cfg.n_steps} ticks (cut "
        f"from 4,380): {tel_cfg.n_steps / wall_t:.1f} ticks/s "
        f"({wall_t / tel_cfg.n_steps / tick_s:.3f}x a tick's wall without); "
        f"decisions and metrics equal phase 4's run at that depth bit for "
        f"bit; rider {json.dumps(short)}")

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
    n_ticks, n_sub = tel_cfg.n_steps, 4     # the stream's every window
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
# every router's run, cut from the 4,380 steps (PR 23: random and cascade
# since PR 19, least utilized and power of two since PR 23)
FLEET_ROUTER_STEPS = dict.fromkeys(("least_utilized", "power_of_two",
                                    "random", "cascade"), SHORT_STEPS)
FLEET_BATCH_STEPS = 360      # phase 12's batch of 24 and its engine
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

    # 1. a fleet of one is make_run: phase 4's decisions at SHORT_STEPS,
    # bit for bit
    one = fleet_config(SHORT_STEPS, capacities=(PAPER_FULL.capacity,))
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
    want = single["second_short"]
    if not torch.equal(accept[:, 0], want["accept"]):
        raise AssertionError("fleet of one: decisions differ from phase 4's")
    for field in want["metrics"]._fields:
        got = getattr(m.per_cluster, field)
        got = got[..., 0, :] if got.ndim > 1 else got[0]
        if not torch.equal(got, getattr(want["metrics"], field)):
            raise AssertionError(f"fleet of one: {field} differs from "
                                 "phase 4's")
    log(f"fleet of one at PAPER_FULL, the first {one.base.n_steps} steps: "
        f"{one.base.n_steps / wall:.1f} steps/s (phase 4's make_run "
        f"{want['steps_per_s']:.1f}); decisions [T, 1, A] and metrics equal "
        "phase 4's run at that depth bit for bit")

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


# ---------------------------------------------------------------------------
# Phase 13: the trace-driven path
# ---------------------------------------------------------------------------

REPLAY_MAX_ARRIVALS = 16     # the JAX sweep's replay cap (scenarios.py)
TRACE_BATCH = 24             # phase 13's replayed batch
TRACE_ENSEMBLE = 32          # phase 13's trace-level plan
TRACE_DEPTH_STEPS = 480      # depth of the replayed run and batch and the
                             # trace plan
TRACE_FLEET_STEPS = 480      # phase 13's fleet replay row
TRACE_ENGINE_TICKS = 360     # phase 13's engine with a drift detector
TRACE_SCRAPE_TICKS = 36      # ... scraped (a detector window) this often
TRACE_NULL_REPS = 3          # stationary engine replays behind its null
BM_CPU_PROBES = 4            # probes whose BM phase 13 repeats on the CPU
# tests/test_traces.py's round-trip tolerances (its latent and observed
# fits; the observed path's implied population means)
FIT_TOL = {"latent": 0.15, "observed": 0.5}
FIT_MEAN_TOL = 0.25


class RecordingSource:
    """A prior-sampling arrival source that keeps every stream it draws,
    by the seed of the generator it drew from."""

    def __init__(self):
        from repro_torch.sim import PriorArrivalSource

        self.inner = PriorArrivalSource()
        self.seen = {}

    def stream(self, gen, cfg):
        s = self.inner.stream(gen, cfg)
        self.seen[gen.initial_seed()] = s
        return s

    def shares_stream(self, cfg):
        return self.inner.shares_stream(cfg)


def stream_diff(a, b) -> list:
    """The leaves (by index) at which two streams differ, each with its
    count of differing elements."""
    import torch

    return [(i, int((x.cpu() != y.cpu()).sum()))
            for i, (x, y) in enumerate(zip(_leaves(a), _leaves(b)))
            if not torch.equal(x.cpu(), y.cpu())]


def _leaves(tree):
    if isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def trace_path(records):
    """Phase 13: the trace-driven path (synthesis and fitting at
    TRACE_FULL, the Azure sample, one replayed run and a replayed batch at
    PAPER_FULL, both importance plans, the quick scenario and drift
    calibrations, the fleet replay row, the engine with a drift
    detector)."""
    import numpy as np
    import torch
    from repro_torch.benchmarks import drift_bench
    from repro_torch.benchmarks.common import SCALES, grid_for, sim_config
    from repro_torch.configs import (PAPER_FULL, PAPER_TABLE2, TRACE_FULL)
    from repro_torch.core import (AZURE_PRIORS, SECOND, fleet_policy,
                                  make_policy)
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.serve import OnlineAdmissionEngine
    from repro_torch.sim import (ROUTERS, draw_arrival_stream,
                                 estimate_from_plan, make_fleet_run,
                                 make_importance_plan, make_run,
                                 make_trace_ensemble_plan, run_keyed_batch,
                                 simulate_plan, simulate_trace_plan,
                                 split_seeds)
    from repro_torch.sim import importance as PI
    from repro_torch.sim.simulator import _steps
    from repro_torch.traces import (TraceArrivalSource, fit_priors,
                                    ingest_cortez_csv, n_deployments,
                                    prior_relative_errors, scenario_names,
                                    synthesize_scenario, trace_to,
                                    trace_to_stream, validate_trace)
    from repro_torch.tuning import (DriftDetector, calibrate_scenario,
                                    channels_from_obs, null_from_replays,
                                    replay_stream_batch)

    rho = PAPER_TABLE2["second_rho"]
    grid = geometric_grid_full()
    cfg = PAPER_FULL._replace(agg_refresh_steps=12)
    rcfg = cfg._replace(max_arrivals=REPLAY_MAX_ARRIVALS)
    # the replayed batch and the trace plan: the first TRACE_DEPTH_STEPS
    # steps of TRACE_FULL traces (later arrivals lie outside the window)
    dcfg = rcfg._replace(horizon_hours=TRACE_DEPTH_STEPS * rcfg.dt)
    policy = make_policy(SECOND, rho=rho, capacity=cfg.capacity)
    launches = {}
    out = {}

    def counted(name, n_steps=None):
        got = dict(K.LAUNCHES)
        if n_steps is not None:
            want = dict.fromkeys(got, 0)
            want.update(moment_curves_belief=n_steps,
                        moment_curves_agg_belief=n_steps // 12)
            if got != want:
                raise AssertionError(f"{name}: launches {got}, want {want}")
        elif not (got["moment_curves_belief"] and
                  got["moment_curves_agg_belief"]):
            raise AssertionError(f"{name}: launches {got}")
        launches[name] = got

    def timed(fn):
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # 1. synthesis of every scenario at TRACE_FULL, and the fits -----------
    traces = {}
    for name in scenario_names():
        tr, wall = timed(lambda: synthesize_scenario(2018, name, TRACE_FULL,
                                                     device=DEVICE))
        validate_trace(tr)
        traces[name] = tr
        log(f"synthesized {name} at TRACE_FULL: {n_deployments(tr)} "
            f"arrivals of {TRACE_FULL.max_deployments} rows, "
            f"{wall * 1e3:.2f} ms")
    base = traces["baseline"]
    for source, tol in FIT_TOL.items():
        (fitted, _), wall = timed(lambda: fit_priors(base, source=source))
        errs = prior_relative_errors(fitted, AZURE_PRIORS)
        worst = max(errs, key=errs.get)
        log(f"fit_priors({source}) on the TRACE_FULL baseline: largest "
            f"relative error {errs[worst]:.4f} ({worst}; limit {tol}), "
            f"{wall:.3f} s")
        if errs[worst] >= tol:
            raise AssertionError(f"fit {source}: {errs}")
        if source == "observed":
            for p in ("mu", "lam", "sig"):
                want = (getattr(AZURE_PRIORS, f"{p}_shape")
                        / getattr(AZURE_PRIORS, f"{p}_rate"))
                got = (getattr(fitted, f"{p}_shape")
                       / getattr(fitted, f"{p}_rate"))
                if abs(got / want - 1.0) > FIT_MEAN_TOL:
                    raise AssertionError(f"observed fit: {p} mean {got}, "
                                         f"want {want}")

    # 2. the Azure sample: ingest, fit, replay, one short run ---------------
    sample = ROOT / "tests" / "data" / "azure_cortez_sample.csv"
    az, diag = ingest_cortez_csv(str(sample), rebucket_dt_hours=6.0,
                                 device=DEVICE)
    az_priors, _ = fit_priors(az, source="observed")
    az_cfg = PAPER_FULL._replace(
        priors=az_priors, capacity=400.0, max_slots=256,
        horizon_hours=6.0 * int(float(az.horizon_hours) // 6.0 + 1))
    az_src = TraceArrivalSource(az)
    m, wall = timed(lambda: make_run(az_cfg, grid, SECOND,
                                     arrival_source=az_src, device=DEVICE)(
        2018, make_policy(SECOND, rho=rho, capacity=az_cfg.capacity)))
    util = float(m.utilization)
    log(f"Azure sample: {diag['n_vms']} VMs, {n_deployments(az)} "
        f"deployments, {diag['n_malformed']} malformed; observed fit "
        f"{tuple(round(x, 4) for x in az_priors)}; replayed "
        f"{az_cfg.n_steps} steps on the card in {wall:.2f} s, utilization "
        f"{util:.4f}, accepted {float(m.arrivals_accepted):.0f}")
    if not (0.0 < util <= 1.0) or float(m.arrivals_accepted) <= 0:
        raise AssertionError(f"Azure replay: {m}")

    # 3. one replayed run at PAPER_FULL, its first TRACE_DEPTH_STEPS steps
    # (PR 23; all 4,380 before) -------------------------------------------
    rcfg = dcfg
    src = TraceArrivalSource(base)
    run = make_run(rcfg, grid, SECOND, arrival_source=src, device=DEVICE)
    m, wall = timed(lambda: run(2018, policy))
    counted("replay", rcfg.n_steps)
    dropped = src.n_dropped(rcfg)
    for field in m:
        if not bool(torch.isfinite(field).all()):
            raise AssertionError("replay: non-finite metrics")
    on_card, _ = trace_to_stream(base, rcfg)
    on_cpu, _ = trace_to_stream(trace_to(base, "cpu"), rcfg)
    diff = stream_diff(on_card, on_cpu)
    if diff:
        raise AssertionError("replay: the card's GLOBAL stream differs "
                             f"from the CPU's at (leaf, elements) {diff}")
    out["replay"] = dict(steps_per_s=rcfg.n_steps / wall, wall_s=wall,
                         dropped=dropped,
                         utilization=float(m.utilization),
                         failure_rate=float(m.failure_rate))
    log(f"replayed TRACE_FULL baseline through make_run at PAPER_FULL, the "
        f"first {rcfg.n_steps} steps (max_arrivals {REPLAY_MAX_ARRIVALS}, "
        f"SECOND rho {rho}): "
        f"{rcfg.n_steps / wall:.1f} steps/s, {dropped} dropped, utilization "
        f"{float(m.utilization):.4f}, failure rate "
        f"{float(m.failure_rate):.3e}; launches {launches['replay']}; the "
        "GLOBAL stream built on the card equals the CPU's bit for bit")

    # 4. a replayed batch: 24 runs, each on its own trace ------------------
    drun = make_run(dcfg, grid, SECOND, device=DEVICE)
    (streams, seeds, dropped), wall_b = timed(lambda: replay_stream_batch(
        11, 12, "baseline", TRACE_FULL, dcfg, TRACE_BATCH, device=DEVICE))
    mb, wall = timed(lambda: run_keyed_batch(drun, seeds, policy,
                                             streams=streams))
    counted("replay batch", dcfg.n_steps)
    util = mb.utilization.cpu()
    if not bool(((util > 0) & (util <= 1)).all()):
        raise AssertionError(f"replay batch: utilizations {util}")
    rate = TRACE_BATCH * dcfg.n_steps / wall
    out["replay_batch"] = dict(runs_steps_per_s=rate, wall_s=wall,
                               build_s=wall_b, dropped=dropped,
                               n_steps=dcfg.n_steps)
    log(f"replay_stream_batch of {TRACE_BATCH} traces ({wall_b:.2f} s to "
        f"synthesize and scatter, {dropped} dropped) through "
        f"run_keyed_batch for {dcfg.n_steps} steps: {wall:.2f} s, "
        f"{rate:.1f} runs x steps/s; utilization mean "
        f"{float(util.mean()):.4f}")
    del streams, mb

    # 5. the seed-level importance plan at PAPER_FULL -----------------------
    torch.cuda.reset_peak_memory_stats()
    plan, probe_s = timed(lambda: make_importance_plan(
        2018, cfg, grid, quotas=(8, 8, 8), n_probe=512, probe_batch=64,
        device=DEVICE))
    peak = torch.cuda.max_memory_allocated()
    bm = plan.bm_probe
    n_nan = int(np.isnan(bm).sum())
    q = np.nanquantile(bm, [0.0, 0.5, 0.9, 0.99, 1.0])
    # the same probes' BM on the CPU: the point-mass curves' float32
    # log-gamma differs by device (ROADMAP Queue C)
    ratio = bm[:BM_CPU_PROBES] / np.asarray(
        [cpu_badness(s, cfg, grid) for s in split_seeds(2018, BM_CPU_PROBES)])
    rec = RecordingSource()
    plan_run = make_run(cfg, grid, SECOND, arrival_source=rec,
                        device=DEVICE)
    mp, wall = timed(lambda: simulate_plan(plan_run, plan, policy))
    counted("seed plan", cfg.n_steps)
    est = estimate_from_plan(plan, mp)
    first = int(plan.keys[0])
    probe = PI._probe_streams([first], cfg, torch.device(DEVICE), None)
    diff = stream_diff(_unbatch(probe), rec.seen[first])
    if diff:
        raise AssertionError("seed plan: a probe's stream differs from its "
                             f"run's at (leaf, elements) {diff}")
    out["seed_plan"] = dict(p_bucket=plan.p_bucket.tolist(),
                            bm_quantiles=q.tolist(), bm_nan=n_nan,
                            bm_card_over_cpu=ratio.tolist(), probe_s=probe_s,
                            peak_bytes=peak, simulate_s=wall, **est)
    log(f"make_importance_plan at PAPER_FULL (512 probes, batches of 64, "
        f"quotas 8/8/8): {probe_s:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB; p_hat {np.round(plan.p_bucket, 4).tolist()}"
        f"; BM min/median/p90/p99/max {np.round(q, 1).tolist()} (edges "
        f"{1.25 * cfg.capacity:.0f}, {1.5 * cfg.capacity:.0f}), NaN in "
        f"{n_nan} probes; the first {BM_CPU_PROBES} probes' BM on the card "
        f"over the same streams' on the CPU {np.round(ratio, 4).tolist()}; "
        f"simulate_plan of {len(plan.keys)} runs {wall:.2f} s; estimate "
        f"utilization {est['utilization']:.4f}, SLA {est['sla_fail']:.3e}; "
        f"seed {first}'s probe stream equals its run's bit for bit")

    # 6. the trace-level plan over 32 baseline replays ----------------------
    (ens, _, _), _ = timed(lambda: replay_stream_batch(
        21, 22, "baseline", TRACE_FULL, dcfg, TRACE_ENSEMBLE,
        device=DEVICE))
    tplan, plan_s = timed(lambda: make_trace_ensemble_plan(
        2018, dcfg, grid, ens, quotas=(4, 2, 2)))
    mt, wall = timed(lambda: simulate_trace_plan(drun, tplan, ens, policy))
    counted("trace plan", dcfg.n_steps)
    test = estimate_from_plan(tplan, mt)
    out["trace_plan"] = dict(p_bucket=tplan.p_bucket.tolist(),
                             plan_s=plan_s, simulate_s=wall,
                             n_steps=dcfg.n_steps, **test)
    log(f"make_trace_ensemble_plan over {TRACE_ENSEMBLE} replays of "
        f"{dcfg.n_steps} steps: {plan_s:.2f} s, p_hat {np.round(tplan.p_bucket, 4).tolist()}; "
        f"simulate_trace_plan of {len(tplan.keys)} runs {wall:.2f} s; "
        f"utilization {test['utilization']:.4f}, SLA "
        f"{test['sla_fail']:.3e}")
    del ens, mt

    # 7. the quick calibrations: a scenario and the drift protocol --------
    scale = SCALES["quick"]
    qcfg = sim_config(scale)._replace(max_arrivals=REPLAY_MAX_ARRIVALS)
    qgrid = grid_for(scale, qcfg, device=DEVICE)

    def scenario_cal():
        from repro_torch.benchmarks.scenarios import trace_spec_for

        streams, seeds, _ = replay_stream_batch(
            100, 500, "flash_crowd", trace_spec_for(qcfg), qcfg,
            scale.n_runs, device=DEVICE)
        return calibrate_scenario(
            make_run(qcfg, qgrid, SECOND, device=DEVICE), SECOND,
            "flash_crowd", streams, seeds, capacity=qcfg.capacity,
            tau=scale.tau, stationary_theta=rho,
            n_grid=scale.n_thresholds, max_stages=1)

    cal, wall = timed(scenario_cal)
    counted("scenario calibration")
    out["scenario_calibration"] = dict(
        util_stat=cal.stationary_util, sla_stat=cal.stationary_sla,
        theta_ret=cal.retuned.theta, util_ret=cal.retuned.utilization,
        sla_ret=cal.retuned.sla_fail, feasible=cal.retuned.feasible,
        n_sims=cal.retuned.n_sims, seconds=wall)
    log(f"calibrate_scenario(flash_crowd, SECOND) at quick: stationary rho "
        f"{rho}: utilization {cal.stationary_util:.4f}, SLA "
        f"{cal.stationary_sla:.2e}; re-tuned rho {cal.retuned.theta:.4g}: "
        f"utilization {cal.retuned.utilization:.4f}, SLA "
        f"{cal.retuned.sla_fail:.2e} (tau {scale.tau:g}, feasible "
        f"{cal.retuned.feasible}); {cal.retuned.n_sims} simulations, "
        f"{wall:.1f} s")
    (res, _), wall = timed(lambda: drift_bench.protocol("quick", 0, DEVICE))
    counted("drift protocol")
    out["drift_protocol"] = dict(drift_bench.summary(res, wall))
    log(f"run_drift_protocol(drift_step, SECOND) at drift_bench's quick: "
        f"theta0 {res.theta0:.4g}; detector fired {res.report.fired} at "
        f"window {res.report.fired_window} (onset {res.onset_window}, "
        f"threshold {res.null.threshold:.3f}); regret never "
        f"{res.never.regret:.4f}, triggered {res.triggered.regret:.4f} "
        f"(oracle utilization {res.oracle.util:.4f}, within CI "
        f"{res.within_ci}); {res.n_sims} simulations, {wall:.1f} s")
    for line in drift_bench.rows(res, wall, "quick"):
        log("  " + line)

    # 8. the fleet replay row at the PAPER_FULL fleet split ---------------
    fcfg = fleet_config(TRACE_FLEET_STEPS)
    fcfg = fcfg._replace(base=fcfg.base._replace(
        max_arrivals=REPLAY_MAX_ARRIVALS))
    fsrc = TraceArrivalSource(base)
    frun = make_fleet_run(fcfg, grid, SECOND,
                          router=ROUTERS["least_utilized"](),
                          arrival_source=fsrc, device=DEVICE)
    fpol = fleet_policy(SECOND, capacities=fcfg.capacities, rho=rho)
    mf, wall = timed(lambda: frun(2018, fpol))
    counted("fleet replay", TRACE_FLEET_STEPS)
    out["fleet_replay"] = dict(utilization=float(mf.utilization),
                               failure_rate=float(mf.failure_rate),
                               dropped=fsrc.n_dropped(fcfg),
                               steps_per_s=TRACE_FLEET_STEPS / wall)
    log(f"scenarios/fleet/replay_least_utilized at the PAPER_FULL fleet "
        f"split ({TRACE_FLEET_STEPS} steps): utilization "
        f"{float(mf.utilization):.4f}, failure rate "
        f"{float(mf.failure_rate):.3e}, dropped {fsrc.n_dropped(fcfg)}, "
        f"{TRACE_FLEET_STEPS / wall:.1f} steps/s")

    # 9. the engine at PAPER_FULL with telemetry and a drift detector -----
    # Its null is calibrated on this engine's own live windows: stationary
    # replays of the same engine, scraped as the checked run is. (The drift
    # protocol's null is over trace windows, whose channels are
    # per-deployment means, not the live ratio rates of channels_from_obs.)
    ecfg = cfg._replace(telemetry=True)
    lanes = np.arange(ecfg.max_arrivals)

    def engine(seed, detector=None):
        """The engine on seed's stationary stream: each scrape's channel
        values (from the telemetry obs deltas) and its ``"drift"``. The
        first scrape, from an empty cluster, is warm-up: the detector is
        reset after it, and its window is left out."""
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        stream = draw_arrival_stream(gen, ecfg)
        n_arr = stream.n_arrivals.cpu().numpy()
        steps = _steps(stream)
        eng = OnlineAdmissionEngine(ecfg, grid, SECOND, policy,
                                    micro_batch=8, drift_detector=detector,
                                    device=DEVICE)
        windows, drifts, prev = [], [], {}
        for t in range(TRACE_ENGINE_TICKS):
            eng.tick(gen=gen)
            eng.decide_slice(steps[t], lanes < n_arr[t])
            if (t + 1) % TRACE_SCRAPE_TICKS == 0:
                snap = eng.metrics_snapshot()
                obs = snap["telemetry"]["obs"]
                windows.append(channels_from_obs(
                    {k: obs[k] - prev.get(k, 0.0) for k in obs}))
                prev = dict(obs)
                drifts.append(snap.get("drift"))
                if detector is not None and len(drifts) == 1:
                    detector.reset()
        return windows[1:], drifts[1:]

    reps, null_s = timed(lambda: [engine(s)[0] for s in
                                  split_seeds(2019, TRACE_NULL_REPS)])
    counted("engine null", TRACE_NULL_REPS * TRACE_ENGINE_TICKS)
    null = null_from_replays(reps)
    (windows, drifts), wall = timed(lambda: engine(2018,
                                                   DriftDetector(null)))
    counted("engine", TRACE_ENGINE_TICKS)
    # the engine's detector state after each scrape equals a detector fed
    # the same scrapes' observable deltas
    det = DriftDetector(null)
    want = []
    for v in windows:
        det.update(v)
        want.append(det.snapshot())
    if drifts != want:
        raise AssertionError(f"engine: drift {drifts}, want {want}")
    drift = drifts[-1]
    if (drift["n_windows"] != TRACE_ENGINE_TICKS // TRACE_SCRAPE_TICKS - 1
            or not math.isfinite(drift["stat"])):
        raise AssertionError(f"engine: drift {drift}")
    out["engine"] = dict(ticks_per_s=TRACE_ENGINE_TICKS / wall,
                         null_s=null_s, null_mean=null.mean,
                         null_std=null.std, drift=drift,
                         stats=[d["stat"] for d in drifts],
                         null_mu_by_window=np.mean(
                             [[v["mu"] for v in r] for r in reps],
                             axis=0).tolist())
    log(f"engine at PAPER_FULL with telemetry and a DriftDetector, "
        f"{TRACE_ENGINE_TICKS} ticks scraped every {TRACE_SCRAPE_TICKS} "
        f"(the first scrape warm-up): "
        f"{TRACE_ENGINE_TICKS / wall:.1f} ticks/s; null from "
        f"{TRACE_NULL_REPS} stationary replays of the engine ({null_s:.1f} "
        f"s), mean {null.mean}, std {null.std}; on a fresh stationary "
        f"stream: drift {drift['stat']:.4f} against threshold "
        f"{null.threshold:.4f}, fired {drift['fired']} (window "
        f"{drift['fired_window']}); every scrape's drift state equals a "
        "detector fed the scrapes' observable deltas")

    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_traces"] = {
            k: v[name] for k, v in launches.items()}
    log("phase 13 numbers: " + json.dumps(out, default=float))


def cpu_badness(seed, cfg, grid):
    """The BM of the probe of ``seed`` with its point-mass curves evaluated
    on the CPU: the card's stream and lifetime clocks, the CPU's i^x."""
    import torch
    from repro_torch.sim import importance as PI
    from repro_torch.sim.core import tree_to

    dev = torch.device(DEVICE)
    stream = _unbatch(PI._probe_streams([seed], cfg, dev, None))
    maxlife = PI._lifetimes([PI.life_generator(seed, dev)],
                            stream.params.mu.reshape(1, -1), cfg)
    i_x = PI.point_mass_ix(tree_to(stream, "cpu"), cfg, grid.cpu())
    occurs = (torch.arange(cfg.max_arrivals)
              < stream.n_arrivals.cpu()[:, None]).reshape(1, -1)
    return float(PI.greedy_schedule(i_x[None].numpy(), maxlife.cpu().numpy(),
                                    occurs.numpy(), cfg)[0])


def _unbatch(stream):
    """The one stream of a stacked batch of one."""
    if isinstance(stream, tuple):
        return type(stream)(*map(_unbatch, stream))
    return stream[0]


# ---------------------------------------------------------------------------
# Phase 14: the benchmark drivers and the examples
# ---------------------------------------------------------------------------

EXAMPLES = ("admission_serving", "quickstart", "calibrate_policy",
            "telemetry_dashboard", "trace_scenarios", "drift_recalibration")
# what the JAX scripts themselves state as true, by example
EXAMPLE_CLAIMS = {"admission_serving": (
    "labeling is the dominant strategy (Prop. 4): True",)}
NOT_FINITE = re.compile(r"\b(nan|inf|infinity)\b", re.IGNORECASE)


def check_finite_text(where, text):
    """Every number printed is finite: no nan or inf token."""
    bad = NOT_FINITE.search(text)
    if bad:
        line = next(ln for ln in text.splitlines() if NOT_FINITE.search(ln))
        raise AssertionError(f"{where}: {bad.group(0)} in {line!r}")


def drivers_path(records):
    """Phase 14: ``tuning_bench`` and ``serve_bench`` at their smoke
    preset through ``run.py``'s writer and read back by
    ``pick_agg_refresh`` and ``load_operating_point``; ``kernels_bench``
    with every CUDA row against its plain row; ``run.main`` twice into one
    file; each example with ``--smoke`` as ``python -m`` runs it."""
    import contextlib
    import io
    import os
    import runpy
    import tempfile

    import torch
    from repro_torch.benchmarks import kernels_bench, serve_bench
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks import tuning_bench
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.serve import load_operating_point
    from repro_torch.tuning import pick_agg_refresh

    launches, seconds = {}, {}
    kernel_names = ("moment_curves_belief", "moment_curves_agg_belief",
                    "flash_attention")

    def counted(tag, fn, want):
        """``fn()`` with the launch counts set to 0 just before and read
        just after; each kernel of ``want`` must have launched."""
        torch.cuda.synchronize()
        K.reset_launches()
        FA.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        got = launches[tag] = {**K.LAUNCHES, **FA.LAUNCHES}
        if not all(got[name] > 0 for name in want):
            raise AssertionError(f"{tag}: launches {got}, each of {want} "
                                 "must launch")
        return out

    def rows_checked(tag, rows):
        for row in rows:
            check_finite_text(tag, row)
            log("  " + row)
        return rows

    mc = kernel_names[:2]
    card = bench_run.device_name(DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 1. the two new drivers at the smoke preset, into one BENCH file
        bench = os.path.join(tmp, "BENCH_smoke.json")
        rows = rows_checked("tuning_bench", counted(
            "tuning", lambda: tuning_bench.run("smoke", 0, DEVICE), mc))
        bench_run.write_artifact(bench, "smoke", 0, seconds["tuning"],
                                 bench_run.records_of(rows, 0, card))
        # serve_bench serves at the thetas of the file just written
        os.environ["REPRO_BENCH_JSON"] = bench
        try:
            rows = rows_checked("serve_bench", counted(
                "serve", lambda: serve_bench.run("smoke", 0, DEVICE), mc))
        finally:
            del os.environ["REPRO_BENCH_JSON"]
        if not any(r.startswith("serve/smoke/sharded,") for r in rows):
            raise AssertionError("serve_bench: no serve/smoke/sharded row")
        written = bench_run.write_artifact(
            bench, "smoke", 0, seconds["serve"],
            bench_run.records_of(rows, 0, card))
        art = json.loads(Path(bench).read_text())
        names = [r["name"] for r in written]
        want_total = round(round(seconds["tuning"], 1) + seconds["serve"], 1)
        if (len(names) != len(set(names)) or art["device"] != card
                or art["total_seconds"] != want_total):
            raise AssertionError(f"the smoke BENCH file: {len(names)} rows, "
                                 f"{len(set(names))} names, device "
                                 f"{art['device']!r}, total "
                                 f"{art['total_seconds']} (want {want_total})")
        by_name = {r["name"]: r["derived"] for r in written}
        k_row = int(re.match(r"K=(\d+)",
                             by_name["tuning/pick_agg_refresh/smoke"])[1])
        k_read = pick_agg_refresh("smoke", bench_path=bench)
        thetas = {}
        for kind in ("zeroth", "first", "second"):
            want = float(re.match(r"theta=(\S+)",
                                  by_name[f"tuning/calibrate/{kind}"])[1])
            op = load_operating_point(kind, "smoke", bench_path=bench)
            if op is None or op.theta != want:
                raise AssertionError(f"load_operating_point({kind!r}): {op}, "
                                     f"the calibrate row's theta {want}")
            thetas[kind] = want
        if k_read != k_row:
            raise AssertionError(f"pick_agg_refresh read K = {k_read}, the "
                                 f"pick_agg_refresh row says {k_row}")
        log(f"smoke BENCH file: {len(names)} rows, total_seconds "
            f"{art['total_seconds']} (tuning + serve), device {card!r}; "
            f"pick_agg_refresh reads K = {k_read} (the row's); "
            f"load_operating_point reads the calibrate thetas {thetas}")

        # 2. kernels_bench: each CUDA row's output against its plain row's
        rows, out = counted("kernels", lambda: kernels_bench.measure(
            0, DEVICE), kernel_names)
        rows_checked("kernels_bench", rows)
        tols = {"curves": (TOL_EL, TOL_VL), "aggregate": (TOL_EL, TOL_VL),
                "attention": (FLASH_TOL["bfloat16"],)}
        for name in kernels_bench.KERNEL_OUTPUTS:
            got, want = out[name + "_cuda"], out[name]
            pairs = (zip(got, want) if name != "attention"
                     else [(got, want)])
            for (g, w), tol in zip(pairs, tols[name]):
                torch.testing.assert_close(g, w, **tol)
        log("kernels_bench: each CUDA row's output equals its plain row's "
            "at phases 3 and 7's tolerances (E[L] rtol 2e-4, V[L] 2e-3; bf16 "
            "flash one bf16 ulp)")

        # 3. run.main twice into one file: the second replaces every row
        path = os.path.join(tmp, "BENCH_tiny.json")
        heads = []
        for _ in range(2):
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                bench_run.main(["--scale", "tiny", "--only", "kernels",
                                "--json", path, "--device", DEVICE])
            check_finite_text("run.main", buf.getvalue())
            heads.append(json.loads(Path(path).read_text()))
        names = [r["name"] for r in heads[1]["rows"]]
        if (len(names) != len(set(names))
                or names != [r["name"] for r in heads[0]["rows"]]
                or heads[1]["device"] != card or heads[1]["seed"] != 0):
            raise AssertionError(f"run.main twice: {names}, {heads[1]}")
        log(f"run.main --only kernels twice: {len(names)} rows, no name "
            f"twice; total_seconds {heads[0]['total_seconds']} then "
            f"{heads[1]['total_seconds']} (every row replaced: the second "
            "call's own)")

    # 4. the examples, each as ``python -m`` runs it
    argv = sys.argv
    for name in EXAMPLES:
        sys.argv = [name, "--smoke", "--device", DEVICE]
        try:
            with contextlib.redirect_stdout(io.StringIO()) as buf:
                counted(name, lambda: runpy.run_module(
                    f"repro_torch.examples.{name}", run_name="__main__",
                    alter_sys=True), mc)
        finally:
            sys.argv = argv
        text = buf.getvalue()
        log(f"-- python -m repro_torch.examples.{name} --smoke "
            f"({seconds[name]:.1f} s)")
        for line in text.splitlines():
            log("  " + line)
        check_finite_text(name, text)
        for claim in EXAMPLE_CLAIMS.get(name, ()):
            if claim not in text:
                raise AssertionError(f"{name}: no line {claim!r}")

    for name in kernel_names:
        records[name]["launches_drivers"] = {
            tag: n[name] for tag, n in launches.items() if n[name]}
    log("phase 14 seconds: " + json.dumps(
        {k: round(v, 2) for k, v in seconds.items()}))


# ---------------------------------------------------------------------------
# Phase 15: the other LM families at their published widths
# ---------------------------------------------------------------------------

# the nine other architectures, in the order phase 15 runs them
FAMILIES = ("hymba-1.5b", "xlstm-125m", "whisper-small",
            "moonshot-v1-16b-a3b", "dbrx-132b", "chameleon-34b",
            "granite-20b", "qwen3-14b", "starcoder2-3b")
# bf16 weights phase 15 holds on the card at once: an architecture whose
# layers do not fit runs as many as do (dbrx-132b's 263 GB and
# chameleon-34b's 68.6 GB do not), leaving the rest of the card's 80 GB to
# the einsum lane's float32 logits and the forward's activations
FAMILY_WEIGHT_BYTES = 60e9
FAMILY_B, FAMILY_S = 2, 2048           # each forward
WHISPER_TOKENS = 448                   # whisper's decoder length
DECODE_STEPS = 8                       # teacher-forced steps after prefill
SSD_CHUNK = 128                        # hybrid and ssm lengths: multiples
HYMBA_PREFILL = 2560                   # past its window of 2,048
# the new (H, KVH, Dh, window) shapes the families give the two attention
# kernels, by the architecture that brings them: G = 5, 6, 12 and 48
FAMILY_ATTN_SHAPES = (("hymba-1.5b", 25, 5, 64, 2048),
                      ("qwen3-14b", 40, 8, 128, 0),
                      ("dbrx-132b", 48, 8, 128, 0),
                      ("starcoder2-3b", 24, 2, 128, 0),
                      ("granite-20b", 48, 1, 128, 0))


def family_kernel_shapes(records):
    """Phase 15, first: flash (B = 2, S = 2,048, bf16) and decode (B = 4,
    4,096 slots, lengths 2,048 / 1 / 4,096 / 0, bf16) at each new shape
    against their plain versions with phase 7's tolerances, bitwise
    repeats; decode also on hymba's rolling buffer once the position has
    passed the window (all 2,048 slots valid); each timed beside SDPA."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    bf16, tol = torch.bfloat16, FLASH_TOL["bfloat16"]
    b, s = FAMILY_B, FAMILY_S
    flash, decode, worst = {}, {}, {}
    for arch, h, kvh, dh, window in FAMILY_ATTN_SHAPES:
        tag = f"G={h // kvh} Dh={dh}" + (f" window={window}" if window
                                           else "")
        q = randn((b, s, h, dh), gen, bf16)
        k = randn((b, s, kvh, dh), gen, bf16)
        v = randn((b, s, kvh, dh), gen, bf16)
        kern = lambda: FA.flash_attention_bshd(q, k, v, causal=True,
                                               window=window)
        got, again = kern(), kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"flash not deterministic at {tag}")
        want32 = FR.flash_attention_ref(q.float(), k.float(), v.float(),
                                        causal=True, window=window)
        torch.testing.assert_close(got.float(), want32.to(bf16).float(),
                                   **tol, msg=lambda m: f"flash {tag}: {m}")
        worst["flash"] = max(worst.get("flash", 0.0), tolerance_used(
            got.float(), want32.to(bf16).float(), tol))
        keys = (s * (s + 1) // 2 if not window else
                sum(min(i + 1, window) for i in range(s)))
        b_ms, b_by = attention_bound(2 * (2 * q.numel() + k.numel()
                                          + v.numel()), 4 * b * h * dh * keys)
        flash[tag] = dict(arch=arch, H=h, KVH=kvh, ms=event_ms(kern),
                          plain_ms=event_ms(lambda: FR.flash_attention_ref(
                              q, k, v, causal=True, window=window),
                              reps=5, warm=1),
                          bound_ms=b_ms, bound_by=b_by,
                          library_ms=event_ms(sdpa_window(q, k, v, window)))
        del q, k, v, got, again, want32

        slots = window or 4096
        q = randn((4, h, dh), gen, bf16)
        k = randn((4, slots, kvh, dh), gen, bf16)
        v = randn((4, slots, kvh, dh), gen, bf16)
        lengths = [slots] * 4 if window else [2048, 1, slots, 0]
        decode_case(q, k, v, lengths, worst)
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        valid = sum(lengths)
        b_ms, b_by = attention_bound(
            2 * 2 * valid * kvh * dh + 2 * q.numel() + 4 * q.numel(),
            4 * h * valid * dh)
        full = torch.full((4,), 2048 if not window else slots,
                          dtype=torch.int32, device=DEVICE)
        kv = (k[:, :int(full[0])], v[:, :int(full[0])])
        decode[tag + (" rolling buffer" if window else "")] = dict(
            arch=arch, H=h, KVH=kvh, lengths=lengths,
            ms=event_ms(lambda: DG.decode_gqa_bshd(q, k, v, lens)),
            plain_ms=event_ms(lambda: DR.decode_gqa_ref(q, k, v, lens)),
            bound_ms=b_ms, bound_by=b_by,
            ms_equal_lengths=event_ms(
                lambda: DG.decode_gqa_bshd(q, k, v, full)),
            library_ms_equal_lengths=event_ms(
                lambda: sdpa(q[:, None], *kv, False)))
        del q, k, v, kv
    for name, rows in (("flash_attention", flash), ("decode_gqa", decode)):
        records[name]["families"] = rows
        for tag, r in rows.items():
            lib = (f"SDPA {r['library_ms']:.4f} ms" if "library_ms" in r
                   else f"equal lengths {r['ms_equal_lengths']:.4f} ms, SDPA "
                   f"{r['library_ms_equal_lengths']:.4f} ms")
            log(f"{name} at {tag} ({r['arch']}, H {r['H']} / KVH "
                f"{r['KVH']}): {r['ms']:.4f} ms a call, plain "
                f"{r['plain_ms']:.4f} ms, {lib}, bound {r['bound_ms']:.6f} "
                f"ms ({r['bound_by']})")
    log("the new shapes match their plain versions (flash within one bf16 "
        "ulp, decode 3e-5); largest share of the tolerance used: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def family_depth(cfg, dtype):
    """(layers to run, why): every layer, or as many as FAMILY_WEIGHT_BYTES
    of weights hold."""
    from repro_torch.models import build_model

    itemsize = 2 if dtype_name(dtype) == "bfloat16" else 4
    outer = build_model(dataclasses.replace(cfg, n_layers=0)).n_params()
    per_layer = (build_model(cfg).n_params() - outer) / cfg.n_layers
    total = itemsize * (outer + cfg.n_layers * per_layer)
    if total <= FAMILY_WEIGHT_BYTES:
        return cfg.n_layers, "full depth"
    depth = int((FAMILY_WEIGHT_BYTES / itemsize - outer) // per_layer)
    return depth, (f"depth cut: its {cfg.n_layers} layers' weights, "
                   f"{total / 1e9:.1f} GB in {dtype_name(dtype)}, exceed "
                   f"the {FAMILY_WEIGHT_BYTES / 1e9:.0f} GB phase 15 holds "
                   "on the 80 GB card")


def family_model(name, dtype):
    """(cfg, model, params) of ``name`` at its published widths, as deep
    as ``family_depth`` allows, weights from a generator on the card."""
    import torch
    from repro_torch.models import build_model, get_config

    cfg = get_config(name)
    full = cfg.n_layers
    depth, why = family_depth(cfg, dtype)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    model = build_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    params = model.init(gen, dtype=dtype, device=DEVICE)
    enc = f" + {cfg.enc_layers} encoder" if cfg.enc_layers else ""
    log(f"-- {name} [{cfg.family}]: d_model {cfg.d_model}, H {cfg.n_heads} "
        f"/ KVH {cfg.n_kv_heads}, head_dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}"
        + (f", {cfg.n_experts} experts top {cfg.moe_top_k}"
           if cfg.n_experts else "")
        + (f", SSM state {cfg.ssm_state}" if cfg.ssm_state else "")
        + (f", window {cfg.window}" if cfg.window else "")
        + f"; {depth}{enc} of {full} layers ({why}), "
        f"{model.n_params():,} parameters in {dtype_name(dtype)}")
    return cfg, model, params


def family_layer_rms(model, params, tokens):
    """The flash lane's forward with each layer's attention also run
    through the einsum lane on the same input: the largest rms difference
    of the two, relative to the output's rms (None: no attention)."""
    import torch
    from repro_torch.models.layers import attention, rmsnorm

    acfg = model.cfg.attn_config()
    x = model._embed(params, tokens)
    worst = None
    for ltype, p in zip(model.layer_types, params["layers"]):
        if ltype in ("attn", "hybrid"):
            h = rmsnorm(p["ln1"], x)
            got = attention(p["attn"], acfg, h, use_kernel=True)
            want = attention(p["attn"], acfg, h, use_kernel=False)
            worst = max(worst or 0.0, compare_logits(got, want)[1])
            del got, want
        x, _ = model._block_apply(ltype, p, x)
        torch.cuda.synchronize()
    return worst


def clone_cache(tree):
    """A copy of a cache (decode steps write attention caches in place)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_cache(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_cache(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_cache(x) for x in tree)
    return tree


def pad_kv_caches(cache, n):
    """A prefilled cache with n empty slots after the prompt's, so that
    decode steps continue the prompt (a cache sized to the prompt clamps
    the first step's write onto its last slot, as the JAX package does):
    every unwindowed KVCache of a layer list, or whisper's self-attention
    caches."""
    import torch
    from repro_torch.models.layers import KVCache

    def pad(kv):
        z = torch.zeros((kv.k.shape[0], n, *kv.k.shape[2:]),
                        dtype=kv.k.dtype, device=kv.k.device)
        return kv._replace(k=torch.cat([kv.k, z], 1),
                           v=torch.cat([kv.v, z], 1))

    if hasattr(cache, "self_kv"):
        return cache._replace(self_kv=[pad(kv) for kv in cache.self_kv])
    return [pad(c) if isinstance(c, KVCache) else c for c in cache]


def counted(launched, fn):
    """``fn()`` with the attention kernels' counts set to 0 just before and
    read just after, added to ``launched``."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.flash_attention import kernel as FA

    torch.cuda.synchronize()
    FA.reset_launches()
    DG.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launched["flash_attention"] += FA.LAUNCHES["flash_attention"]
    launched["decode_gqa"] += DG.LAUNCHES["decode_gqa"]
    return out


def moe_drops(model, params, tokens):
    """Layer 0's MoE on the forward's tokens (T = B S) and on a B = 4
    decode step's tokens: (dropped fraction, capacity) of each."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import attention, rmsnorm

    cfg, p = model.cfg, params["layers"][0]
    x = model._embed(params, tokens)
    x = x + attention(p["attn"], cfg.attn_config(), rmsnorm(p["ln1"], x))
    h2 = rmsnorm(p["ln2"], x)
    out = {}
    for tag, h in (("prefill", h2), ("decode", h2[:, :2].reshape(
            4, 1, cfg.d_model))):
        m = moe_lib.moe(p["ffn"], cfg.moe_config(), h)
        t = h.shape[0] * h.shape[1]
        out[tag] = (float(m.dropped_frac),
                    moe_lib.capacity(t, cfg.moe_config()), t)
    return out


def family_path(name, launched, out):
    """One architecture: forward with the flash lane on and off; the
    per-layer attention gate; prefill and teacher-forced decode steps with
    the decode kernel on and off against the forward's logits; MoE
    determinism and drops; two requests served."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    cfg, model, params = family_model(name, torch.bfloat16)
    rng = np.random.default_rng(15)
    audio = cfg.family == "audio"
    s = WHISPER_TOKENS if audio else FAMILY_S
    if cfg.window:
        s = HYMBA_PREFILL + SSD_CHUNK   # the decode steps' positions too
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (FAMILY_B, s))
                              ).to(DEVICE)
    extra = {}
    if audio:
        extra["frames"] = randn((FAMILY_B, cfg.enc_seq, cfg.d_model),
                                torch.Generator(device=DEVICE).manual_seed(16),
                                torch.bfloat16)
    lanes = {lane: build_model(dataclasses.replace(cfg, use_flash_kernel=lane))
             for lane in (True, False)}
    flash = counted(launched, lambda: lanes[True].forward(params, tokens,
                                                          **extra))
    if flash.shape != (FAMILY_B, s, cfg.vocab) or flash.dtype != cfg.dtype:
        raise AssertionError(f"{name}: logits {flash.shape} {flash.dtype}")
    if not bool(torch.isfinite(flash).all()):
        raise AssertionError(f"{name}: non-finite logits")
    plain = lanes[False].forward(params, tokens, **extra)
    diff, rms, same = compare_logits(flash, plain)
    del plain
    r = dict(depth=cfg.n_layers, logits_rms=rms, logits_argmax=same)
    layer = None if audio else family_layer_rms(lanes[True], params, tokens)
    r["layer_rms"] = layer
    log(f"  forward B={FAMILY_B} S={s}"
        + (f" ({cfg.enc_seq} frames)" if audio else "")
        + f", flash lane against the einsum lane: logits max |diff| "
        f"{diff:.3e}, rms diff / rms {rms:.3e}, equal argmax {same:.4f}; "
        + ("whisper's attention never takes the flash kernel" if audio
           else "no attention layer" if layer is None
           else f"per layer, attention rms diff / rms at most {layer:.3e}"))
    if layer is not None and layer > BF16_TOL:
        raise AssertionError(f"{name}: a layer's attention lanes differ by "
                             f"{layer:.3e}")
    if cfg.family == "moe":
        again = lanes[True].forward(params, tokens)
        if not torch.equal(again, flash):
            raise AssertionError(f"{name}: two forwards differ")
        del again
        drops = moe_drops(model, params, tokens)
        r["dropped"] = drops
        log("  two forwards are bit-equal; layer 0's MoE drops "
            + ", ".join(f"{tag} (T = {t}, capacity {cap}) {frac:.4f}"
                        for tag, (frac, cap, t) in drops.items()))

    # prefill, then teacher-forced decode steps against the forward
    p_len = (HYMBA_PREFILL if cfg.window else
             s - DECODE_STEPS if audio else s - SSD_CHUNK)
    logits_p, cache = model.prefill(params, tokens[:, :p_len], **extra)
    if not cfg.window:
        cache = pad_kv_caches(cache, DECODE_STEPS)
    want = flash[:, p_len:p_len + DECODE_STEPS].float()
    pre = compare_logits(logits_p, flash[:, p_len - 1])
    steps = {}
    for lane in (True, False):
        c = clone_cache(cache)

        def decode(c=c, lane=lane):
            out = []
            for t in range(DECODE_STEPS):
                lg, c = model.decode_step(params, tokens[:, p_len + t], c,
                                          use_kernel=lane)
                out.append(lg)
            return torch.stack(out, 1)

        steps[lane] = counted(launched, decode) if lane else decode()
        if not bool(torch.isfinite(steps[lane]).all()):
            raise AssertionError(f"{name}: non-finite decode logits")
    del cache, c, decode
    kern_vs_fwd = compare_logits(steps[True], want)
    plain_vs_fwd = compare_logits(steps[False], want)
    lanes_gap = compare_logits(steps[True], steps[False])
    r.update(prefill_rms=pre[1], decode_kernel_rms=kern_vs_fwd[1],
             decode_einsum_rms=plain_vs_fwd[1], decode_lanes_rms=lanes_gap[1],
             decode_kernel_argmax=kern_vs_fwd[2])
    log(f"  prefill {p_len} tokens, then {DECODE_STEPS} teacher-forced "
        f"decode steps: prefill logits against the forward's rms "
        f"{pre[1]:.3e}; decode against the forward's logits at the same "
        f"positions, kernel lane rms {kern_vs_fwd[1]:.3e} (equal argmax "
        f"{kern_vs_fwd[2]:.4f}), einsum lane rms {plain_vs_fwd[1]:.3e} "
        f"({plain_vs_fwd[2]:.4f}); kernel lane against einsum lane rms "
        f"{lanes_gap[1]:.3e}")
    # held as phase 8 holds the logits (5x its bf16 limit over 12-52
    # layers). For MoE only the two decode lanes, on the same cache and
    # tokens, and at the per-layer limit: its capacity follows T, so a
    # prefill (T = B x prompt) and a decode step (T = B, capacity 1) drop
    # assignments that the forward keeps, as the reference does
    if cfg.family == "moe":
        worst, limit = lanes_gap[1], BF16_TOL
    else:
        worst = max(pre[1], kern_vs_fwd[1], plain_vs_fwd[1], lanes_gap[1])
        limit = 5 * BF16_TOL
    if worst > limit:
        raise AssertionError(f"{name}: prefill or decode lanes differ by "
                             f"{worst:.3e} (limit {limit:.0e})")
    del flash, steps, want

    # two requests through the launcher's engine at this depth
    if name != "hymba-1.5b":
        args = S.parse_args(["--arch", name, "--requests", "2"])
        reqs, done, secs = S.serve(model, params, args, cfg.vocab)
        n_tok = sum(len(q.out_tokens) for q in reqs)
        if len(done) != len(reqs) or not all(q.done for q in reqs):
            raise AssertionError(f"{name}: {len(done)}/{len(reqs)} served")
        r["served_tokens_per_s"] = n_tok / secs
        log(f"  served {len(done)}/{len(reqs)} requests, {n_tok} tokens in "
            f"{secs:.2f} s ({n_tok / secs:.1f} tokens/s)")
    del model, params, lanes
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    out[name] = r


def serve_lm_example():
    """``python -m repro_torch.examples.serve_lm --smoke`` on the card, as
    phase 14 runs the other examples: it exits, prints no NaN or infinity,
    and answers its 4 requests."""
    import contextlib
    import io
    import runpy

    argv = sys.argv
    sys.argv = ["serve_lm", "--smoke", "--device", DEVICE]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            runpy.run_module("repro_torch.examples.serve_lm",
                             run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    text = buf.getvalue()
    log(f"-- python -m repro_torch.examples.serve_lm --smoke "
        f"({time.perf_counter() - t0:.1f} s)")
    for line in text.splitlines():
        log("  " + line)
    check_finite_text("serve_lm", text)
    if not text.startswith("served 4 requests"):
        raise AssertionError("serve_lm: no 'served 4 requests' line")


def families_path(records):
    """Phase 15: the kernels at the families' new shapes; each of the nine
    other architectures at its published widths; hymba-1.5b at full depth
    served through ``launch.serve``. Both attention kernels must launch on
    the model paths (counted from 0 around each)."""
    import torch
    from repro_torch.launch import serve as S

    family_kernel_shapes(records)
    launched = {"flash_attention": 0, "decode_gqa": 0}
    out = {}
    for name in FAMILIES:
        family_path(name, launched, out)

    args = S.parse_args(["--arch", "hymba-1.5b", "--requests", "8",
                         "--max-new", "32"])
    cfg, model, params = S.build(args)
    reqs, done, secs = S.serve(model, params, args, cfg.vocab)
    n_tok = sum(len(q.out_tokens) for q in reqs)
    if len(done) != len(reqs) or not all(
            q.done and 1 <= len(q.out_tokens) <= args.max_new for q in reqs):
        raise AssertionError(f"hymba-1.5b: {len(done)}/{len(reqs)} served")
    out["hymba-1.5b"]["served_tokens_per_s"] = n_tok / secs
    log(f"-- launch.serve --arch hymba-1.5b (32 layers, float32 weights, "
        f"bf16 activations): {len(done)}/{len(reqs)} requests, {n_tok} "
        f"tokens in {secs:.2f} s ({n_tok / secs:.1f} tokens/s)")
    del model, params
    torch.cuda.empty_cache()
    serve_lm_example()

    for kernel, n in launched.items():
        if n == 0:
            raise AssertionError(f"{kernel} never launched in phase 15")
        records[kernel]["launches_families"] = n
    log(f"phase 15 launches (model paths, counted from 0 around each): "
        f"flash {launched['flash_attention']}, decode "
        f"{launched['decode_gqa']}")
    log("phase 15 numbers: " + json.dumps(out, default=float))


# ---------------------------------------------------------------------------
# Phase 16: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20                 # the full-width run at the launcher's defaults
FIT_STEPS, FIT_DROP = 8, 1.0     # one batch fitted: its loss falls 1 nat
SERVING_SHAPE = (4, 2048)        # (B, S) of the full-width steps at length
SERVING_STEPS = 3
FT_STEPS, FT_FAIL_AT, FT_CKPT_EVERY = 12, 6, 4
# the largest parameter gap of the reduced run resumed after a failure
# against the uninterrupted run, both on the card: 0, bit for bit, in the
# first run of phase 16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 23)
FT_GAP_LIMIT = 0.0
# one reduced config of each family: a train step on the card against the
# CPU, loss and grad_norm at this tolerance
TRAIN_FAMILIES = ("llama3.2-1b", "dbrx-132b", "hymba-1.5b", "xlstm-125m",
                  "whisper-small")
TRAIN_CARD_TOL = 1e-4
TRAIN_LINE = re.compile(r"\[train\] step=(\d+) loss=(\S+) ")


def run_train(argv):
    """``launch.train.train`` on ``parse_args(argv)`` with its output
    captured; returns (final step, {"losses": {step: loss}, "step_s":
    {step: seconds}, "saves": [{"step", "s", "bytes", "tree"}], "text"}).
    The launcher's synchronous ``checkpointer.save`` (its final save) is
    timed and the tree it wrote kept; the straggler watchdog's observations
    give each step's seconds."""
    import contextlib
    import io

    import torch
    from repro_torch.launch import train as T

    saves, step_s = [], {}
    save, watchdog = T.checkpointer.save, T.StragglerWatchdog

    def timed_save(directory, step, tree):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(directory, step, tree)
        secs = time.perf_counter() - t0
        saves.append({"step": step, "s": secs, "tree": tree,
                      "bytes": sum(f.stat().st_size
                                   for f in Path(path).iterdir())})
        return path

    class Recording(watchdog):
        def observe(self, step, step_time):
            step_s[step] = step_time
            return super().observe(step, step_time)

    T.checkpointer.save, T.StragglerWatchdog = timed_save, Recording
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            final = T.train(T.parse_args(argv))
    finally:
        T.checkpointer.save, T.StragglerWatchdog = save, watchdog
    text = buf.getvalue()
    losses = {int(m.group(1)): float(m.group(2))
              for m in TRAIN_LINE.finditer(text)}
    return final, {"losses": losses, "step_s": step_s, "saves": saves,
                   "text": text}


def leaves_equal(got, want):
    """(leaves, leaves that differ in any bit) of two trees of tensors."""
    import torch
    from repro_torch.models.spec import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} leaves against {len(b)}")
    return len(a), sum(not (x.dtype == y.dtype and torch.equal(x, y))
                       for x, y in zip(a, b))


def full_width_run(out):
    """Phase 16, 1: llama3.2-1b at full width through ``launch.train``, the
    final 14.8 GB checkpoint restored bit for bit. Returns the final
    state."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.models import build_model, get_config

    vocab = get_config("llama3.2-1b").vocab
    n_params = build_model(get_config("llama3.2-1b")).n_params()
    state_bytes = 3 * 4 * n_params           # params, m and v in float32
    ckdir = tempfile.mkdtemp(prefix="repro_train_")
    free = shutil.disk_usage(ckdir).free
    if free < 1.1 * state_bytes:
        raise AssertionError(
            f"phase 16 writes a {state_bytes / 1e9:.1f} GB checkpoint under "
            f"{ckdir}, which has {free / 1e9:.1f} GB free: set TMPDIR to a "
            "larger disk")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final, rec = run_train(
            ["--arch", "llama3.2-1b", "--steps", str(TRAIN_STEPS),
             "--ckpt-every", str(TRAIN_STEPS + 1), "--log-every", "1",
             "--ckpt-dir", ckdir])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = rec["losses"]
        first, last = losses[0], losses[TRAIN_STEPS - 1]
        if final != TRAIN_STEPS or not all(map(math.isfinite,
                                               losses.values())):
            raise AssertionError(f"train: final step {final}, losses "
                                 f"{losses}")
        step_s = statistics.median(
            s for k, s in rec["step_s"].items() if k >= 2)
        tokens = 8 * 128
        (sv,) = rec["saves"]
        state = sv["tree"]
        with open(Path(ckdir) / f"step_{TRAIN_STEPS}" / "manifest.json") as f:
            shards = json.load(f)["n_shards"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = checkpointer.restore(ckdir, TRAIN_STEPS, state,
                                        device=DEVICE)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        n, differ = leaves_equal(restored, state)
        del restored
        if differ:
            raise AssertionError(f"{differ} of {n} restored leaves differ")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"-- launch.train --arch llama3.2-1b (full width, {n_params:,} "
        f"parameters, float32 state, bf16 compute, remat, einsum lane), B 8, "
        f"S 128, {TRAIN_STEPS} steps in {wall:.1f} s: loss {first:.4f} -> "
        f"{last:.4f}; {1e3 * step_s:.1f} ms a step (median of steps >= 2), "
        f"{tokens / step_s:.0f} tokens/s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"   final checkpoint: {sv['bytes'] / 1e9:.2f} GB in {shards} shards, "
        f"saved in {sv['s']:.1f} s ({sv['bytes'] / 1e9 / sv['s']:.2f} GB/s, "
        f"device to host to disk), restored to the card in {restore_s:.1f} s "
        f"({sv['bytes'] / 1e9 / restore_s:.2f} GB/s); {n} leaves equal bit "
        "for bit")
    log("   losses: " + " ".join(f"{losses[k]:.4f}" for k in sorted(losses))
        + f" (ln V = {math.log(vocab):.4f}: the synthetic tokens are near "
        "uniform over the vocabulary at this length)")
    out["default"] = dict(loss0=first, loss_last=last, ms=1e3 * step_s,
                          tokens_per_s=tokens / step_s, peak_gib=peak / 2**30,
                          save_gb=sv["bytes"] / 1e9, save_s=sv["s"],
                          restore_s=restore_s, shards=shards, wall_s=wall)
    return state


def step_count(out):
    """Phase 16, 1a: the dry run's count of the launcher's step (llama3.2-1b
    at full width, B 8, S 128, one device) on meta tensors, on the host:
    its FLOPs and bytes, their roofline bound at the card's peaks
    (``repro_torch.benchmarks.roofline``) beside the step's measured ms."""
    import torch
    from repro_torch.benchmarks import roofline
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.device import Mesh
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model, get_config

    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    shape = ShapeConfig("phase16", "train", 128, 8)
    mesh = Mesh([torch.device("meta")], ("data", "model"), (1, 1))
    c = dryrun.count_cell(cfg, model, shape, mesh, microbatches=1)
    flops, nbytes = c["flops"][0], c["bytes"][0]
    compute_s, memory_s = (flops / roofline.PEAK_FLOPS,
                           nbytes / roofline.HBM_BW)
    bound_s = max(compute_s, memory_s)
    step_s = out["default"]["ms"] / 1e3
    model_flops = 6 * model.n_active_params() * 8 * 128
    out["count"] = dict(flops=flops, bytes=nbytes, temp=c["peak"][0],
                        compute_ms=1e3 * compute_s, memory_ms=1e3 * memory_s,
                        bound_ms=1e3 * bound_s, step_ms=1e3 * step_s,
                        fraction=bound_s / step_s,
                        model_flop_share=model_flops / (
                            step_s * roofline.PEAK_FLOPS),
                        useful=model_flops / flops, seconds=c["seconds"])
    log(f"-- the dry run's count of that step (meta tensors, on the host, "
        f"{c['seconds']:.2f} s): {flops:.4e} FLOPs, {nbytes:.4e} bytes, "
        f"{c['peak'][0] / 2**30:.2f} GiB live at most; roofline at "
        f"{roofline.PEAK_FLOPS:.3g} FLOP/s and {roofline.HBM_BW:.3g} B/s: "
        f"compute {1e3 * compute_s:.2f} ms, memory {1e3 * memory_s:.2f} ms, "
        f"bound {1e3 * bound_s:.2f} ms against {1e3 * step_s:.1f} ms "
        f"measured: fraction {bound_s / step_s:.4f}; 6 N tokens / step "
        f"time {out['count']['model_flop_share']:.4f} of the bf16 peak; "
        f"useful FLOPs {out['count']['useful']:.3f} of those counted")


def fit_one_batch(state, out):
    """Phase 16, 1b: the launcher's step on batch 0 profiled once; then
    ``FIT_STEPS`` steps of ``make_train_step`` at a constant lr of 1e-3 on
    that one batch, whose loss must fall by ``FIT_DROP`` nats: the full-
    width gradients and updates learn (the launcher's 20 steps on fresh
    batches cannot lower a loss that starts at ln V)."""
    from repro_torch.data.pipeline import make_batch, to_device
    from repro_torch.launch import train as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    _, model, _, step_fn, pipe_cfg = T.build(T.parse_args([]))
    batch = to_device(make_batch(pipe_cfg, 0), DEVICE)
    holder = [state]

    def one_step():
        holder[0], m = step_fn(holder[0], batch)
        return m

    wall, busy, n_k, by_name = profile_device(one_step)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"-- profile of one launcher step (B 8, S 128): wall {wall:.1f} ms "
        f"(profiler on), device busy {busy:.1f} ms (idle share "
        f"{1 - busy / wall:.3f}), {n_k} kernels; top: "
        + "; ".join(f"{k[:60]} {t:.2f} ms" for k, t in top))
    fit = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=1000))
    state, losses = holder[0], []
    for _ in range(FIT_STEPS):
        state, m = fit(state, batch)
        losses.append(float(m["loss"]))
    log(f"-- one batch, {FIT_STEPS} steps at lr 1e-3: loss "
        + " ".join(f"{x:.4f}" for x in losses))
    if not losses[-1] < losses[0] - FIT_DROP:
        raise AssertionError(f"one batch: loss {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}, not falling")
    out["profile"] = dict(wall_ms=wall, busy_ms=busy, kernels=n_k)
    out["fit"] = dict(first=losses[0], last=losses[-1])
    return state


def serving_shape_steps(state, out):
    """Phase 16, 2: full-width steps at the serving shape; then
    microbatches and compression at the launcher's defaults."""
    import torch
    from repro_torch.data.pipeline import make_batch, to_device
    from repro_torch.launch import train as T
    from repro_torch.optim.compression import init_error_feedback
    from repro_torch.train.step import TrainState

    def steps(argv, state):
        args = T.parse_args(argv + ["--steps", str(SERVING_STEPS)])
        _, model, _, step_fn, pipe_cfg = T.build(args)
        times, metrics = [], []
        for s in range(SERVING_STEPS):
            batch = to_device(make_batch(pipe_cfg, s), DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            m = {k: float(v) for k, v in m.items()}
            times.append(time.perf_counter() - t0)
            metrics.append(m)
            if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm",
                                                      "lr")):
                raise AssertionError(f"{argv}: step {s} {m}")
        return model, state, times, metrics

    b, s = SERVING_SHAPE
    torch.cuda.reset_peak_memory_stats()
    model, state, times, metrics = steps(
        ["--batch", str(b), "--seq-len", str(s)], state)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    flops = 6 * model.n_params() * b * s
    log(f"-- full width at B {b}, S {s}: {1e3 * step_s:.1f} ms a step "
        f"(median of steps 1-{SERVING_STEPS - 1}; step 0 "
        f"{1e3 * times[0]:.1f}), {b * s / step_s:.0f} tokens/s, 6 N tokens "
        f"/ step time {flops / step_s / 1e12:.1f} TFLOP/s = "
        f"{flops / step_s / PEAK_BF16_PER_S:.3f} of 989 TFLOP/s bf16; peak "
        f"device memory {peak / 2**30:.2f} GiB; loss "
        f"{metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}")
    out["serving_shape"] = dict(ms=1e3 * step_s, ms_first=1e3 * times[0],
                                tokens_per_s=b * s / step_s,
                                mfu=flops / step_s / PEAK_BF16_PER_S,
                                peak_gib=peak / 2**30)
    _, state, times, metrics = steps(["--microbatches", "2"], state)
    log(f"-- microbatches 2 (B 8, S 128): {1e3 * statistics.median(times):.1f}"
        f" ms a step, last loss {metrics[-1]['loss']:.4f}, grad_norm "
        f"{metrics[-1]['grad_norm']:.4f}, lr {metrics[-1]['lr']:.3e}")
    compressed = TrainState(state.params, state.opt,
                            init_error_feedback(state.params))
    _, compressed, times, metrics = steps(["--compress"], compressed)
    log(f"-- compress (B 8, S 128): {1e3 * statistics.median(times):.1f} ms a "
        f"step, last loss {metrics[-1]['loss']:.4f}, grad_norm "
        f"{metrics[-1]['grad_norm']:.4f}, lr {metrics[-1]['lr']:.3e}")
    return TrainState(compressed.params, compressed.opt, None)


def trained_weights_forward(params, records, out):
    """Phase 16, 3: the trained weights through the flash lane and the
    einsum lane without grad (phase 8's checks); under grad the flash
    kernel refuses."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import DecoderLM, get_config
    from repro_torch.models.layers import attention, rmsnorm

    cfg = get_config("llama3.2-1b")
    models = {lane: DecoderLM(dataclasses.replace(cfg, use_flash_kernel=lane))
              for lane in (True, False)}
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, (2, 2048)).astype(np.int64)).to(DEVICE)
    with torch.no_grad():
        torch.cuda.synchronize()
        FA.reset_launches()
        flash = models[True].forward(params, tokens)
        torch.cuda.synchronize()
        launches = FA.LAUNCHES["flash_attention"]
        if launches != cfg.n_layers:
            raise AssertionError(f"flash lane launched {launches} kernels, "
                                 f"want {cfg.n_layers}")
        if not bool(torch.isfinite(flash).all()):
            raise AssertionError("non-finite logits")
        diff, rms, same = compare_logits(
            flash, models[False].forward(params, tokens))
    del flash
    log(f"-- the trained weights, forward B 2, S 2048, bf16, no grad: flash "
        f"lane {launches} launches; logits against the einsum lane: max "
        f"|diff| {diff:.3e}, rms diff / rms {rms:.3e}, equal argmax "
        f"{same:.4f}")
    if rms > 5 * BF16_TOL or same < 0.9:
        raise AssertionError("bf16 lanes disagree on the trained weights")
    p = params["layers"][0]
    h = rmsnorm(p["ln1"], params["embed"][tokens[:, :64]].to(cfg.dtype))
    FA.reset_launches()
    try:
        attention(p["attn"], cfg.attn_config(), h, use_kernel=True)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"   under grad, attention(use_kernel=True) raises: {e}")
    else:
        raise AssertionError("the flash kernel ran under autograd")
    if FA.LAUNCHES["flash_attention"]:
        raise AssertionError("the refused call launched the flash kernel")
    records["flash_attention"]["launches_training"] = launches
    out["trained_forward"] = dict(rms=rms, equal_argmax=same)


def resume_on_card(out):
    """Phase 16, 4: reduced llama3.2-1b through ``launch.train`` with a
    failure mid-run against an uninterrupted run; then the example."""
    import contextlib
    import io
    import runpy
    import shutil
    import tempfile

    import torch
    from repro_torch.models.spec import tree_leaves

    finals = {}
    for name, extra in (("uninterrupted", []),
                        ("failed", ["--fail-at", str(FT_FAIL_AT)])):
        ckdir = tempfile.mkdtemp(prefix="repro_ft_")
        try:
            final, rec = run_train(
                ["--reduced", "--steps", str(FT_STEPS), "--ckpt-every",
                 str(FT_CKPT_EVERY), "--ckpt-dir", ckdir] + extra)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        restarts = rec["text"].count("restart #")
        if final != FT_STEPS or restarts != (1 if extra else 0):
            raise AssertionError(f"{name}: final {final}, {restarts} "
                                 "restarts")
        finals[name] = rec["saves"][-1]["tree"]
        resumed = re.search(r"resumed from step (\d+)", rec["text"])
        if extra:
            if resumed is None:
                raise AssertionError(f"{name}: the restart resumed from no "
                                     "checkpoint")
            resumed_at = int(resumed.group(1))
    gap = max(float((a - b).abs().max().detach()) for a, b in zip(
        tree_leaves(finals["failed"].params),
        tree_leaves(finals["uninterrupted"].params)))
    log(f"-- reduced llama3.2-1b, {FT_STEPS} steps, a failure at step "
        f"{FT_FAIL_AT}, resumed from step {resumed_at} (checkpoint every "
        f"{FT_CKPT_EVERY}): largest parameter gap to the uninterrupted run "
        f"{gap:.3e} (limit {FT_GAP_LIMIT:g})")
    if gap > FT_GAP_LIMIT:
        raise AssertionError(f"resumed run differs by {gap:.3e}")
    out["resume_gap"] = gap

    argv = sys.argv
    sys.argv = ["train_lm", "--smoke"]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            runpy.run_module("repro_torch.examples.train_lm",
                             run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    text = buf.getvalue()
    log(f"-- python -m repro_torch.examples.train_lm --smoke "
        f"({time.perf_counter() - t0:.1f} s): {text.splitlines()[-1]}")
    check_finite_text("train_lm", text)
    if "trained to step 8" not in text:
        raise AssertionError("train_lm: no 'trained to step 8' line")
    torch.cuda.empty_cache()


def train_card_against_cpu(out):
    """Phase 16, 5: one train step of each family's reduced config on the
    card against the CPU (float32, no TF32)."""
    import torch
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.models import build_model, get_config, reduced_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    worst = {}
    for name in TRAIN_FAMILIES:
        cfg = reduced_config(get_config(name))
        model = build_model(cfg)
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=8))
        audio = cfg.family == "audio"
        batch = make_batch(PipelineConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=4,
            frames_dim=cfg.d_model if audio else 0,
            enc_seq=cfg.enc_seq if audio else 0), 0)
        metrics = {}
        for d in ("cpu", DEVICE):
            state = init_train_state(model, torch.Generator().manual_seed(0),
                                     device=d)
            _, m = step(state, {k: torch.from_numpy(v).to(d)
                                for k, v in batch.items()})
            metrics[d] = {k: float(v) for k, v in m.items()}
        rel = max(abs(metrics[DEVICE][k] - metrics["cpu"][k])
                  / max(abs(metrics["cpu"][k]), 1e-30)
                  for k in ("loss", "grad_norm"))
        worst[name] = rel
        if rel > TRAIN_CARD_TOL or not math.isfinite(metrics["cpu"]["loss"]):
            raise AssertionError(f"{name}: card against CPU {metrics}")
    log("-- a train step, card against CPU (reduced configs, float32), "
        "largest relative gap of loss and grad_norm: " + ", ".join(
            f"{k} {v:.2e}" for k, v in worst.items())
        + f" (limit {TRAIN_CARD_TOL:g})")
    out["card_vs_cpu"] = worst


def training_path(records):
    """Phase 16: llama3.2-1b trained at full width through
    ``launch.train`` (checkpoint restored bit for bit), steps at the
    serving shape, microbatches and compression, the trained weights
    through the flash kernel without grad, a resumed run on the card, the
    example, and a train step of each family card against CPU."""
    import torch

    out = {}
    t0 = time.perf_counter()
    state = full_width_run(out)
    step_count(out)
    state = fit_one_batch(state, out)
    state = serving_shape_steps(state, out)
    trained_weights_forward(state.params, records, out)
    del state
    torch.cuda.empty_cache()
    out["full_width_s"] = time.perf_counter() - t0
    resume_on_card(out)
    train_card_against_cpu(out)
    log("phase 16 numbers: " + json.dumps(out, default=float))


# ---------------------------------------------------------------------------
# Phase 17: the admission system's mesh
# ---------------------------------------------------------------------------


def mesh_engine(cfg, grid, policy, shards):
    """The online engine ticked with a generator seeded 2018 for
    ``MESH_TICKS`` ticks, one 8-lane ``decide_slice`` a tick, its slot table
    over ``shards`` devices. Returns its accept masks, every refreshed
    aggregate ([refreshes, 2, N] on the host), metrics, rider, decisions,
    the timed ticks' wall, each timed flush's host seconds, and
    ``profile_device``'s numbers of the last ``MESH_PROFILE`` ticks (left
    out of the times)."""
    import numpy as np
    import torch
    from repro_torch.core import SECOND
    from repro_torch.serve import OnlineAdmissionEngine
    from repro_torch.sim import draw_arrival_stream
    from repro_torch.sim.simulator import _steps

    gen = torch.Generator(device=DEVICE).manual_seed(2018)
    stream = draw_arrival_stream(gen, cfg)
    n_arr = stream.n_arrivals.cpu().numpy()
    lanes = np.arange(cfg.max_arrivals)
    steps = _steps(stream)
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy, micro_batch=8,
                                shards=shards, device=DEVICE)
    refreshed, refresh = [], eng.core.refresh_aggregates

    def recording(cs):
        cs = refresh(cs)
        refreshed.append(torch.stack([cs.agg_el, cs.agg_vl]))
        return cs

    eng.core = eng.core._replace(refresh_aggregates=recording)
    accepts, host_s = [], []

    def one(t):
        eng.tick(gen=gen)
        h0 = time.perf_counter()
        accepts.append(eng.decide_slice(steps[t], lanes < n_arr[t]))
        return time.perf_counter() - h0

    timed = MESH_TICKS - MESH_PROFILE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(timed):
        host_s.append(one(t))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decided = eng.decisions
    profiled = profile_device(lambda: [one(t) for t in range(timed,
                                                             MESH_TICKS)])
    return dict(accept=np.stack(accepts), metrics=eng.metrics(),
                refreshed=torch.stack(refreshed).cpu(), tel=eng._cs.tel,
                decided=decided, ticks=timed, wall=wall, host_s=host_s,
                profiled=profiled, n_shards=eng.n_shards)


def mesh_matmul_rows():
    """Whether cuBLAS gives a row of ``[M, 25] @ [25, 48]`` (the fused
    lane's former D-term interpolation, ND = 24, N = 48) the same
    bits at every row count M: the number of M-row chunks of an 8,192-row
    product that differ from its rows, for M = 1, 8, 512, 2,048."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.rand(8192, 25, generator=gen, device=DEVICE)
    w = torch.rand(25, 48, generator=gen, device=DEVICE)
    full = x @ w
    return {m: sum(not torch.equal(x[lo:lo + m] @ w, full[lo:lo + m])
                   for lo in range(0, 8192, m))
            for m in (1, 8, 512, 2048)}


def mesh_path(records):
    """Phase 17: the mesh with 4 logical devices on the card."""
    import os

    import numpy as np
    import torch
    from repro_torch.benchmarks import common
    from repro_torch.configs import PAPER_FULL, PAPER_TABLE2
    from repro_torch.core import SECOND, make_policy
    from repro_torch.device import DEVICE_COUNT_VAR, canonical_device
    from repro_torch.kernels.moment_curves import kernel as K
    from repro_torch.sim import (make_importance_plan, make_run,
                                 run_keyed_batch, split_seeds)
    from repro_torch.tuning import calibrate

    old = os.environ.get(DEVICE_COUNT_VAR)
    os.environ[DEVICE_COUNT_VAR] = str(MESH_SHARDS)
    try:
        card = canonical_device(DEVICE)
        logical = [card] * MESH_SHARDS
        grid = geometric_grid_full()
        policy = make_policy(SECOND, rho=PAPER_TABLE2["second_rho"],
                             capacity=PAPER_FULL.capacity)
        out, launches, seconds = {}, {}, {}

        def counted(tag, fn, want):
            """``fn()`` with the launch counts set to 0 just before and
            read just after; each kernel of ``want`` must have launched."""
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            seconds[tag] = time.perf_counter() - t0
            got = launches[tag] = dict(K.LAUNCHES)
            if not all(got[name] > 0 for name in want):
                raise AssertionError(f"mesh {tag}: launches {got}, each of "
                                     f"{want} must launch")
            return result

        # 1. the engine, its 8,192 slots over 4 logical devices against 1
        cfg = short_config()._replace(
            horizon_hours=MESH_TICKS * PAPER_FULL.dt, telemetry=True,
            agg_backend="fused")
        one = counted("engine_one", lambda: mesh_engine(cfg, grid, policy,
                                                        None),
                      ("moment_curves_belief",))
        four = counted("engine", lambda: mesh_engine(cfg, grid, policy,
                                                     MESH_SHARDS),
                       ("moment_curves_belief",))
        if not np.array_equal(one["accept"], four["accept"]):
            bad = np.argwhere(one["accept"] != four["accept"])
            raise AssertionError(f"sharded engine: decisions differ at "
                                 f"(tick, lane) {bad[:5].tolist()}")
        agg_gap = float((one["refreshed"] - four["refreshed"]).abs().max())
        if (one["refreshed"].shape != four["refreshed"].shape
                or agg_gap != 0.0):
            raise AssertionError(f"sharded engine: refreshed aggregates "
                                 f"{tuple(four['refreshed'].shape)}, gap "
                                 f"{agg_gap}")
        for name in one["metrics"]._fields:
            if not torch.equal(getattr(one["metrics"], name),
                               getattr(four["metrics"], name)):
                raise AssertionError(f"sharded engine: {name} differs")
        for a, b in zip(one["tel"], four["tel"]):
            if not torch.equal(a, b):
                raise AssertionError("sharded engine: the rider differs")
        if four["n_shards"] != MESH_SHARDS:
            raise AssertionError(f"sharded engine: {four['n_shards']} shards")
        for tag, r in (("shards=1", one), ("shards=4", four)):
            p_wall, p_busy, p_kernels, _ = r["profiled"]
            out[tag] = dict(
                ticks_per_s=r["ticks"] / r["wall"],
                decisions_per_s=r["decided"] / r["wall"],
                flush_host_ms_p50=_percentile_ms(r["host_s"], 0.5),
                flush_host_ms_p99=_percentile_ms(r["host_s"], 0.99),
                kernels_a_tick=p_kernels / MESH_PROFILE,
                idle_share=1 - p_busy / p_wall)
            log(f"engine at PAPER_FULL ({cfg.max_slots} slots, fused lane, "
                f"micro-batch 8, rider on), {tag}: {r['ticks']} timed ticks "
                f"{out[tag]['ticks_per_s']:.1f} ticks/s, "
                f"{out[tag]['decisions_per_s']:.1f} decisions/s; a flush's "
                f"host ms p50 {out[tag]['flush_host_ms_p50']:.4f}, p99 "
                f"{out[tag]['flush_host_ms_p99']:.4f}; profile of the last "
                f"{MESH_PROFILE} ticks: {out[tag]['kernels_a_tick']:.2f} CUDA "
                f"kernels a tick, idle share {out[tag]['idle_share']:.3f}")
        log(f"sharded engine ({MESH_SHARDS} x {cfg.max_slots // MESH_SHARDS} "
            f"slots on logical devices of one card) against shards=1: "
            f"decisions, {len(four['refreshed'])} refreshed aggregates (gap "
            f"{agg_gap}), metrics and rider equal bit for bit; launches "
            f"{launches['engine']}; ticks/s sharded over unsharded "
            f"{out['shards=4']['ticks_per_s']
                / out['shards=1']['ticks_per_s']:.3f}")

        # 2. phase 4b's seeds split over the 4: 24 runs, then a ragged 22
        b_cfg = short_config()._replace(
            horizon_hours=MESH_BATCH_STEPS * PAPER_FULL.dt)
        run = make_run(b_cfg, grid, SECOND, device=DEVICE)
        seeds = split_seeds(2018, 23)
        seeds.insert(5, 2018)
        for n_runs in MESH_BATCHES:
            tag = f"batch_{n_runs}"
            got = {}
            for where, devices in (("one", [card]), ("split", logical)):
                got[where] = counted(
                    f"{tag}_{where}", lambda: run_keyed_batch(
                        run, seeds[:n_runs], policy, devices=devices),
                    ("moment_curves_belief", "moment_curves_agg_belief"))
            for name in got["one"]._fields:
                if not torch.equal(getattr(got["one"], name),
                                   getattr(got["split"], name)):
                    raise AssertionError(f"split batch of {n_runs}: {name} "
                                         "differs from one device's")
            work = n_runs * b_cfg.n_steps
            out[tag] = {where: work / seconds[f"{tag}_{where}"]
                        for where in got}
            log(f"a batch of {n_runs} runs x {b_cfg.n_steps} steps "
                f"(phase 4b's seeds; padded to "
                f"{-(-n_runs // MESH_SHARDS) * MESH_SHARDS}) split over "
                f"{MESH_SHARDS} logical devices: {out[tag]['split']:.1f} "
                f"runs x steps/s, against one device's "
                f"{out[tag]['one']:.1f}; every field equal bit for bit (gap "
                f"0); launches {launches[tag + '_split']}")

        # 3. calibration at smoke and the importance probe at PAPER_FULL
        scale = common.scale_for("smoke")
        c_cfg = common.sim_config(scale)
        c_run = make_run(c_cfg, common.grid_for(scale, c_cfg), SECOND,
                         device=DEVICE)
        keys = split_seeds(0, scale.n_runs)
        cal = {where: counted(f"calibrate_{where}", lambda: calibrate(
            c_run, SECOND, keys, capacity=c_cfg.capacity, tau=scale.tau,
            devices=devices), ("moment_curves_belief",
                               "moment_curves_agg_belief"))
            for where, devices in (("one", [card]), ("split", logical))}
        a, b = cal["one"], cal["split"]
        if a.theta != b.theta or len(a.stages) != len(b.stages) or not all(
                np.array_equal(x.agg_fail, y.agg_fail)
                and np.array_equal(x.util, y.util)
                for x, y in zip(a.stages, b.stages)):
            raise AssertionError(f"calibrate over {MESH_SHARDS} devices: "
                                 f"theta {b.theta} against {a.theta}, or "
                                 "the rates differ")
        log(f"calibrate at smoke ({c_cfg.max_slots} slots, {c_cfg.n_steps} "
            f"steps, {len(keys)} runs, {a.n_sims} simulations): theta "
            f"{a.theta:.6g} over 1 device and over {MESH_SHARDS}, every "
            f"stage's rates bit for bit; {seconds['calibrate_one']:.2f} s "
            f"against {seconds['calibrate_split']:.2f} s")
        plans = {where: counted(f"probe_{where}", lambda: make_importance_plan(
            2018, PAPER_FULL, grid, n_probe=MESH_PROBES,
            probe_batch=MESH_PROBES, device=DEVICE, devices=devices), ())
            for where, devices in (("one", [card]), ("split", logical))}
        bm_one, bm_split = plans["one"].bm_probe, plans["split"].bm_probe
        if not (np.array_equal(bm_one, bm_split)
                and np.isfinite(bm_one).all()):
            raise AssertionError("importance probe over 4 devices: BM "
                                 "differs")
        log(f"a {MESH_PROBES}-probe make_importance_plan at PAPER_FULL: BM "
            f"equal over 1 and {MESH_SHARDS} devices (median "
            f"{float(np.median(bm_one)):.1f}); {seconds['probe_one']:.2f} s "
            f"against {seconds['probe_split']:.2f} s")

        # 4. what made the fused lane's interpolation row-independent
        out["matmul_rows_differing"] = mesh_matmul_rows()
        log("cuBLAS [M, 25] @ [25, 48] chunks of an 8,192-row product whose "
            "rows differ from the product's, by M: "
            f"{out['matmul_rows_differing']}")
    finally:
        if old is None:
            del os.environ[DEVICE_COUNT_VAR]
        else:
            os.environ[DEVICE_COUNT_VAR] = old
    for name in ("moment_curves_belief", "moment_curves_agg_belief"):
        records[name]["launches_mesh"] = {
            tag: n[name] for tag, n in launches.items() if n[name]}
    out["seconds"] = seconds
    log("phase 17 numbers: " + json.dumps(out, default=float))



# phase 18: the LM scaffold over 4 logical devices of the card
LM_MESH_DEVICES = 4
LM_MESH_REQUESTS = 4
LM_MESH_DECODE = dict(B=4, slots=4096, filled=2048, steps=8)
LM_MESH_MOE_LAYERS = 4       # moonshot's depth cut: 4 of its 48 layers
LM_MESH_MOE_TOKENS = (2, 128)
LM_MESH_TRAIN = dict(B=8, S=128, steps=3)
LM_MESH_PIPE = dict(S=4, L=8, D=1024, M=8, MB=16, T=128)
LM_MESH_TOL = 1e-4           # float32 logits, sharded against unsharded
LM_MESH_LOSS_RTOL = 2e-4     # tests/test_distribution.py's
# bf16 logits, sharded against unsharded: the sharded einsum lane rounds the
# normalised p to bf16 as the unsharded one does, so only float32 sums in
# another order remain (before that repair: rms 1.667e-02, argmax 0.8947)
LM_MESH_BF16_RMS = 5e-3
LM_MESH_BF16_ARGMAX = 0.95


def lm_mesh_engines(cfg, model, params, dtype, mesh):
    """The launcher's requests through ``ServeEngine`` over ``mesh`` and
    unsharded, activations in ``dtype``: the unsharded engine's tokens, and
    each decode step's logits of both, the sharded engine following the
    unsharded one's tokens (so that every step is compared even where a
    bf16 argmax differs). Returns (tokens equal, per-step (sharded logits,
    unsharded logits), per-step sharded argmax, seconds of each engine)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    model = build_model(dataclasses.replace(cfg, dtype=dtype))
    args = S.parse_args(["--requests", str(LM_MESH_REQUESTS)])

    class Recording(ServeEngine):
        def _greedy(self, logits):
            self.logits.append(logits.float().cpu())
            return super()._greedy(logits)

    class Following(ServeEngine):
        def _greedy(self, logits):
            self.logits.append(logits.float().cpu())
            self.argmax.append(super()._greedy(logits))
            return self.script[len(self.logits) - 1]

    out, secs = {}, {}
    for tag, cls, m in (("plain", Recording, None),
                        ("sharded", Following, mesh)):
        engine = cls(model, params, max_batch=args.max_batch,
                     max_seq=args.max_seq, mesh=m)
        engine.logits, engine.argmax = [], []
        if tag == "sharded":
            engine.script = [lg.argmax(-1).numpy().astype(np.int32)
                             for lg in out["plain"].logits]
        reqs = S.make_requests(args, cfg.vocab)
        for r in reqs:
            engine.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_until_drained()
        torch.cuda.synchronize()
        secs[tag] = time.perf_counter() - t0
        engine.reqs = reqs
        out[tag] = engine
    plain, sharded = out["plain"], out["sharded"]
    equal = all(np.array_equal(a, lg.argmax(-1).numpy())
                for a, lg in zip(sharded.argmax, plain.logits))
    return (equal, list(zip(sharded.logits, plain.logits)),
            sum(len(r.out_tokens) for r in plain.reqs), secs)


def lm_mesh_decode_kernel(cfg, params, mesh):
    """Teacher-forced ``decode_step(use_kernel=True)`` at full width over
    a 4,096-slot bf16 cache, 2,048 slots filled, laid out per
    ``cache_shardings`` over ``mesh`` (its sequence over the 4 devices)
    against the unsharded kernel lane on a copy, activations in float32.
    Returns (largest logit gap, decode kernel launches of the sharded
    steps counted from 0, ms a step sharded, ms a step unsharded)."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.models import build_model
    from repro_torch.models.layers import KVCache
    from repro_torch.models.spec import Sharded, place_tree

    d = LM_MESH_DECODE
    model = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    acfg = cfg.attn_config()
    shape = (d["B"], d["slots"], acfg.n_kv_heads, acfg.head_dim)
    plain = []
    for _ in range(cfg.n_layers):
        k = torch.zeros(shape, dtype=torch.bfloat16, device=DEVICE)
        v = torch.zeros_like(k)
        k[:, :d["filled"]] = randn((d["B"], d["filled"], *shape[2:]), gen,
                                   torch.bfloat16)
        v[:, :d["filled"]] = randn((d["B"], d["filled"], *shape[2:]), gen,
                                   torch.bfloat16)
        plain.append(KVCache(k, v, torch.tensor(d["filled"],
                                                dtype=torch.int32,
                                                device=DEVICE)))
    sharded = place_tree(plain, model.cache_shardings(
        mesh, d["B"], d["slots"], torch.bfloat16))
    blocks = sharded[0].k
    if not (isinstance(blocks, Sharded) and len({b.data_ptr()
                                                 for b in blocks.blocks})
            == mesh.size and blocks.blocks[0].shape[1]
            == d["slots"] // mesh.size):
        raise AssertionError("the decode cache is not sequence-sharded")
    tokens = torch.randint(2, cfg.vocab, (d["steps"], d["B"]), generator=gen,
                           device=DEVICE)
    gap, ms = 0.0, {"sharded": [], "plain": []}
    launches = 0
    for t in range(d["steps"]):
        torch.cuda.synchronize()
        DG.reset_launches()
        t0 = time.perf_counter()
        got, sharded = model.decode_step(params, tokens[t], sharded, mesh,
                                         use_kernel=True)
        torch.cuda.synchronize()
        ms["sharded"].append(1e3 * (time.perf_counter() - t0))
        launches += DG.LAUNCHES["decode_gqa_lse"]
        if DG.LAUNCHES["decode_gqa"]:
            raise AssertionError("the sharded decode launched the kernel "
                                 "without its log-sum-exp")
        t0 = time.perf_counter()
        want, plain = model.decode_step(params, tokens[t], plain,
                                        use_kernel=True)
        torch.cuda.synchronize()
        ms["plain"].append(1e3 * (time.perf_counter() - t0))
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"sharded decode step {t}: not finite")
        torch.testing.assert_close(got, want, rtol=LM_MESH_TOL,
                                   atol=LM_MESH_TOL)
        gap = max(gap, float((got - want).abs().max()))
    # layer 0's new K/V come from the same inputs; a later layer's from
    # hidden states an ulp apart, which bf16 may round a step apart: held
    # to one bf16 ulp of the cache's largest entry
    if not torch.equal(sharded[0].k.gather(), plain[0].k):
        raise AssertionError("layer 0: the sharded cache's K differs from "
                             "the unsharded one's")
    for i in range(cfg.n_layers):
        k_s, k_p = sharded[i].k.gather().float(), plain[i].k.float()
        rel = float((k_s - k_p).abs().max() / k_p.abs().max())
        if rel > 2 ** -7:
            raise AssertionError(f"layer {i}: the sharded cache's K is "
                                 f"{rel:.3e} of its largest entry off")
    want_launches = d["steps"] * cfg.n_layers * mesh.size
    if launches != want_launches:
        raise AssertionError(f"decode kernel (log-sum-exp form) launched "
                             f"{launches} times, want {want_launches}: one "
                             "a shard a layer a step")
    return (gap, launches, statistics.median(ms["sharded"][1:]),
            statistics.median(ms["plain"][1:]))


def lm_mesh_lse_record(records, launches):
    """The decode kernel's log-sum-exp form at phase 7's decode shape (B 4,
    2,048 valid keys of a 4,096-slot bf16 cache, llama3.2-1b's heads):
    against its plain version, its time beside the form without it (whose
    output must keep its bits), the bound of its bytes."""
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    b, slots, valid, h, kvh, dh = 4, 4096, 2048, 32, 8, 64
    q = randn((b, h, dh), gen, torch.bfloat16)
    k = randn((b, slots, kvh, dh), gen, torch.bfloat16)
    v = randn((b, slots, kvh, dh), gen, torch.bfloat16)
    lens = torch.tensor([valid, 0, 1, slots], dtype=torch.int32,
                        device=DEVICE)
    out, lse = DG.decode_gqa_bshd(q, k, v, lens, return_lse=True)
    want_out, want_lse = DR.decode_gqa_ref(q, k, v, lens, return_lse=True)
    if not torch.equal(out, DG.decode_gqa_bshd(q, k, v, lens)):
        raise AssertionError("the output with the log-sum-exp differs from "
                             "the output without it")
    if not (bool(torch.isneginf(lse[1]).all())
            and bool(torch.isfinite(lse[[0, 2, 3]]).all())):
        raise AssertionError("log-sum-exp: -inf at length 0 and finite "
                             "elsewhere")
    torch.testing.assert_close(out, want_out, **DECODE_TOL)
    finite = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[finite], want_lse[finite], **DECODE_TOL)
    err = max(float((out - want_out).abs().max()),
              float((lse[finite] - want_lse[finite]).abs().max()))
    lens = torch.full((b,), valid, dtype=torch.int32, device=DEVICE)
    kern = lambda: DG.decode_gqa_bshd(q, k, v, lens, return_lse=True)
    nbytes = (2 * 2 * b * valid * kvh * dh + 2 * q.numel() + 4 * q.numel()
              + 4 * b * h)
    b_ms, b_by = attention_bound(nbytes, 4 * b * h * valid * dh)
    records["decode_gqa_lse"] = dict(
        name="decode_gqa_lse", route="cuda",
        source="src/repro_torch/kernels/decode_gqa/csrc/decode_gqa.cu",
        replaces="src/repro/kernels/decode_gqa/kernel.py:26",
        launches=launches, max_abs_err=err, ms=event_ms(kern),
        plain_ms=event_ms(lambda: DR.decode_gqa_ref(q, k, v, lens,
                                                    return_lse=True)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        device_ms=graph_ms(kern),
        device_ms_without_lse=graph_ms(
            lambda: DG.decode_gqa_bshd(q, k, v, lens)),
        shape=dict(B=b, slots=slots, valid=valid, H=h, KVH=kvh, Dh=dh,
                   dtype="bfloat16"))
    r = records["decode_gqa_lse"]
    log(f"decode_gqa with its log-sum-exp at {r['shape']}: {r['ms']:.4f} ms "
        f"a call ({r['device_ms']:.4f} ms on the device, CUDA graph; "
        f"without it {r['device_ms_without_lse']:.4f}), plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
        f"({r['bound_by']}); max abs err {err:.3e} (output and log-sum-exp, "
        "lengths 2,048, 0, 1 and 4,096); the output keeps its bits")


def lm_mesh_moe(mesh, out):
    """moonshot-v1-16b-a3b at full width (64 experts, 16 a model rank),
    ``LM_MESH_MOE_LAYERS`` layers, float32, expert-parallel over ``mesh``:
    the forward at capacity factor 8 against the global dispatch's, and
    layer 0's dropped fraction at the config's capacity."""
    import torch
    from repro_torch.models import build_model, get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import attention, rmsnorm

    full = get_config("moonshot-v1-16b-a3b")
    cfg = dataclasses.replace(full, n_layers=LM_MESH_MOE_LAYERS,
                              dtype=torch.float32, moe_capacity_factor=8.0)
    local = build_model(dataclasses.replace(cfg, moe_local_dispatch=True))
    glob = build_model(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    params = local.init(gen, device=DEVICE)
    b, s = LM_MESH_MOE_TOKENS
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = local.forward(params, tokens, mesh)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    want = glob.forward(params, tokens)
    torch.testing.assert_close(got, want, rtol=LM_MESH_TOL, atol=LM_MESH_TOL)
    gap = float((got - want).abs().max())
    p = params["layers"][0]
    x = local._embed(params, tokens)
    x = x + attention(p["attn"], cfg.attn_config(), rmsnorm(p["ln1"], x))
    h2 = rmsnorm(p["ln2"], x)
    drops = {}
    for cf in (8.0, full.moe_capacity_factor):
        mcfg = cfg.moe_config()._replace(capacity_factor=cf)
        drops[cf] = (float(moe_lib.moe_local(p["ffn"], mcfg, h2,
                                             mesh).dropped_frac),
                     float(moe_lib.moe(p["ffn"], mcfg, h2).dropped_frac),
                     moe_lib.capacity(b * s, mcfg))
    out["moe"] = dict(layers=LM_MESH_MOE_LAYERS, of=full.n_layers,
                      params=local.n_params(), tokens=b * s, gap=gap,
                      forward_s=sec, dropped=drops)
    log(f"moonshot-v1-16b-a3b at full width ({cfg.n_experts} experts top "
        f"{cfg.moe_top_k}, {cfg.n_experts // mesh.axis_size('model')} a "
        f"model rank; depth cut to {LM_MESH_MOE_LAYERS} of {full.n_layers} "
        f"layers, {local.n_params():,} parameters in float32), B {b} S {s}, "
        f"moe_local_dispatch over {mesh.shape}: forward at capacity factor "
        f"8 against the global dispatch's, max |diff| {gap:.3e} (limit "
        f"{LM_MESH_TOL}), {sec:.3f} s; layer 0's dropped fraction "
        + ", ".join(f"cf {cf}: local {a:.4f}, global {g:.4f} (capacity "
                    f"{c})" for cf, (a, g, c) in drops.items()))


def lm_mesh_train(out):
    """llama3.2-1b at full width, 3 steps at B 8, S 128 over (2, 2) against
    the unsharded step from the same state: the loss within 2e-4 each
    step; ms a step and peak memory of each."""
    import torch
    from repro_torch.data.pipeline import PipelineConfig, make_batch, \
        to_device
    from repro_torch.device import Mesh, canonical_device
    from repro_torch.models import build_model, get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.elastic import reshard_in_memory
    from repro_torch.train.step import init_train_state, make_train_step

    t = LM_MESH_TRAIN
    model = build_model(get_config("llama3.2-1b"))
    card = canonical_device(DEVICE)
    mesh = Mesh([card] * 4, ("data", "model"), (2, 2))
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=t["steps"])
    pipe = PipelineConfig(vocab=model.cfg.vocab, seq_len=t["S"],
                          global_batch=t["B"])
    batches = [to_device(make_batch(pipe, i), DEVICE)
               for i in range(t["steps"])]
    losses, ms, peak = {}, {}, {}
    for tag, m in (("plain", None), ("sharded", mesh)):
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        state = init_train_state(model, gen, device=DEVICE)
        if m is not None:
            state = reshard_in_memory(state, model, m)
        step = make_train_step(model, opt, m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses[tag], ms[tag] = [], []
        for batch in batches:
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses[tag].append(float(metrics["loss"]))
            ms[tag].append(1e3 * (time.perf_counter() - t0))
        peak[tag] = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, step
        torch.cuda.empty_cache()
    for i, (a, b) in enumerate(zip(losses["sharded"], losses["plain"])):
        if not (math.isfinite(a) and abs(a - b) <= LM_MESH_LOSS_RTOL
                * abs(b)):
            raise AssertionError(f"train step {i} over (2, 2): loss {a} "
                                 f"against {b}")
    out["train"] = dict(losses=losses, ms=ms, peak_gib=peak)
    log(f"llama3.2-1b at full width, {t['steps']} train steps at B "
        f"{t['B']}, S {t['S']} (float32 state, bf16 compute, remat) over "
        f"(2, 2) against one device: losses {losses['sharded']} against "
        f"{losses['plain']} (limit {LM_MESH_LOSS_RTOL} relative); ms a step "
        f"{[round(x, 1) for x in ms['sharded']]} against "
        f"{[round(x, 1) for x in ms['plain']]}; peak memory "
        f"{peak['sharded']:.2f} GiB against {peak['plain']:.2f} GiB")


def lm_mesh_pipeline(out):
    """The GPipe pipeline on 4 stages of the card's logical devices against
    the sequential stack: forward and gradients at tests/test_pipeline.py's
    bounds."""
    import torch
    from repro_torch.device import Mesh, canonical_device
    from repro_torch.train.pipeline import (make_pipeline_forward,
                                            sequential_reference)

    c = LM_MESH_PIPE
    mesh = Mesh([canonical_device(DEVICE)] * c["S"], ("stage",), (c["S"],))
    gen = torch.Generator(device=DEVICE).manual_seed(18)
    params = {"w": (torch.randn(c["L"], c["D"], c["D"], generator=gen,
                                device=DEVICE) * c["D"] ** -0.5
                    ).requires_grad_(True),
              "b": (torch.randn(c["L"], c["D"], generator=gen,
                                device=DEVICE) * 0.1).requires_grad_(True)}
    x = torch.randn(c["M"], c["MB"], c["T"], c["D"], generator=gen,
                    device=DEVICE)

    def stage_fn(p, h):
        for w, b in zip(p["w"], p["b"]):
            h = torch.tanh(h @ w + b)
        return h

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = make_pipeline_forward(stage_fn, c["S"], mesh)(params, x)
    g_got = torch.autograd.grad(got.square().sum(), list(params.values()))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    want = sequential_reference(stage_fn, c["S"], params, x)
    g_want = torch.autograd.grad(want.square().sum(), list(params.values()))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
    out["pipeline"] = dict(seconds=sec,
                           gap=float((got - want).detach().abs().max()))
    log(f"pipeline over {c['S']} stages ({c['L']} layers of {c['D']}, "
        f"{c['M']} microbatches of {c['MB']} x {c['T']}): forward max |diff| "
        f"{out['pipeline']['gap']:.3e} from the sequential stack, gradients "
        f"within rtol 5e-4 / atol 5e-5; forward and backward {sec:.3f} s")


def lm_mesh_restore(out):
    """A reduced llama3.2-1b train state, saved, restored onto (1, 4),
    (4, 1) and (2, 2) of the card's logical devices bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.device import Mesh, canonical_device
    from repro_torch.models import build_model, get_config, reduced_config
    from repro_torch.models.spec import Sharded, gather, tree_leaves
    from repro_torch.runtime.elastic import reshard_restore
    from repro_torch.train.step import init_train_state

    model = build_model(reduced_config(get_config("llama3.2-1b")))
    state = init_train_state(model, torch.Generator(
        device=DEVICE).manual_seed(3), compress=True, device=DEVICE)
    card = canonical_device(DEVICE)
    path = tempfile.mkdtemp()
    try:
        checkpointer.save(path, 5, state)
        for shape in ((1, 4), (4, 1), (2, 2)):
            mesh = Mesh([card] * 4, ("data", "model"), shape)
            got, step = reshard_restore(model, path, mesh, compress=True)
            leaves = tree_leaves(got)
            if step != 5 or not all(
                    torch.equal(gather(a), b.detach())
                    for a, b in zip(leaves, tree_leaves(state))):
                raise AssertionError(f"restore onto {shape}: not bit for "
                                     "bit")
            n = sum(isinstance(x, Sharded) and len(x.unique()) > 1
                    for x in leaves)
            log(f"reduced llama3.2-1b train state (with error feedback) "
                f"restored onto {shape}: {len(leaves)} leaves bit for bit, "
                f"{n} of them split over devices")
    finally:
        shutil.rmtree(path, ignore_errors=True)


def lm_mesh_path(records):
    """Phase 18: the LM scaffold over 4 logical devices of the card."""
    import os

    import torch
    from repro_torch.device import DEVICE_COUNT_VAR
    from repro_torch.launch import serve as S
    from repro_torch.launch.mesh import make_host_mesh

    old = os.environ.get(DEVICE_COUNT_VAR)
    os.environ[DEVICE_COUNT_VAR] = str(LM_MESH_DEVICES)
    out = {}
    try:
        mesh = make_host_mesh(DEVICE)
        if mesh.shape != (1, LM_MESH_DEVICES):
            raise AssertionError(f"host mesh {mesh.shape}")
        cfg, model, params = S.build(S.parse_args([]))
        # 1. the engine at full width and depth, float32 then bf16
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            equal, steps, n_tok, secs = lm_mesh_engines(cfg, model, params,
                                                        dtype, mesh)
            got = torch.cat([a for a, _ in steps])
            want = torch.cat([b for _, b in steps])
            gap, rms, argmax = compare_logits(got, want)
            out[f"engine_{name}"] = dict(tokens_equal=equal, gap=gap,
                                         rms=rms, argmax=argmax,
                                         steps=len(steps), tokens=n_tok,
                                         seconds=secs)
            if dtype == torch.float32:
                if not equal:
                    raise AssertionError("engine over the mesh: tokens "
                                         "differ from the unsharded engine")
                torch.testing.assert_close(got, want, rtol=LM_MESH_TOL,
                                           atol=LM_MESH_TOL)
            elif rms > LM_MESH_BF16_RMS or argmax < LM_MESH_BF16_ARGMAX:
                raise AssertionError(
                    f"bf16 engine over the mesh: logits rms gap {rms:.3e} "
                    f"(limit {LM_MESH_BF16_RMS}), equal argmax {argmax:.4f} "
                    f"(limit {LM_MESH_BF16_ARGMAX})")
            log(f"ServeEngine(mesh={mesh.shape}) at llama3.2-1b full width "
                f"and depth, activations {name}, {LM_MESH_REQUESTS} "
                f"requests, {len(steps)} decode steps, {n_tok} tokens: "
                f"tokens {'equal to' if equal else 'not all equal to'} the "
                f"unsharded engine's; logits max |diff| {gap:.3e}, rms gap "
                f"{rms:.3e}, equal argmax {argmax:.4f}; "
                f"{secs['sharded']:.2f} s sharded against "
                f"{secs['plain']:.2f} s")
        # 2. the kernel lane over the sequence-sharded cache
        gap, launches, ms_s, ms_p = lm_mesh_decode_kernel(cfg, params, mesh)
        out["decode_kernel"] = dict(gap=gap, launches=launches,
                                    ms_sharded=ms_s, ms_plain=ms_p)
        log(f"decode_step(use_kernel=True) at full width over a "
            f"{LM_MESH_DECODE['slots']}-slot bf16 cache sharded "
            f"{LM_MESH_DEVICES} ways along its sequence, "
            f"{LM_MESH_DECODE['filled']} slots filled, B "
            f"{LM_MESH_DECODE['B']}, float32 activations: logits max |diff| "
            f"{gap:.3e} from the unsharded kernel lane (limit "
            f"{LM_MESH_TOL}); {launches} launches of the log-sum-exp form "
            f"(one a shard a layer a step); {ms_s:.2f} ms a step against "
            f"{ms_p:.2f} ms")
        del model, params
        torch.cuda.empty_cache()
        lm_mesh_lse_record(records, launches)
        # 3. expert-parallel MoE
        lm_mesh_moe(mesh, out)
        torch.cuda.empty_cache()
        # 4. training over (2, 2); 5. the pipeline; 6. elastic restores
        lm_mesh_train(out)
        lm_mesh_pipeline(out)
        lm_mesh_restore(out)
    finally:
        if old is None:
            del os.environ[DEVICE_COUNT_VAR]
        else:
            os.environ[DEVICE_COUNT_VAR] = old
    log("phase 18 numbers: " + json.dumps(out, default=float))


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

    with phase("4e. Fig. 1 at tiny and Fig. 2 at quick"):
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

    with phase("13. the trace-driven path"):
        trace_path(records)

    with phase("14. the benchmark drivers and the examples"):
        drivers_path(records)

    with phase("15. the other LM families at their published widths"):
        families_path(records)

    del cfg, model, params
    torch.cuda.empty_cache()
    with phase("16. training"):
        training_path(records)

    with phase("17. the mesh at PAPER_FULL"):
        mesh_path(records)

    with phase("18. the LM scaffold over 4 logical devices"):
        lm_mesh_path(records)

    log(card)
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
