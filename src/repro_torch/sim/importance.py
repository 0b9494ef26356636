"""Importance sampling for tail (SLA) estimation — paper Appendix D.

SLA failures are concentrated in a small fraction of "bad" runs (runs whose
early arrivals include too many large, long-lived deployments). Appendix D
defines a cheap *badness measure* BM(r) computed from the pre-drawn arrival
stream alone (Def. 5), buckets runs by BM, and oversamples bad buckets.

  * ``badness_measure`` — Def. 5: per-deployment 99% Cantelli upper bound
    i^x = E[L] + sqrt(0.99/0.01 * V[L]) from *point-mass* beliefs at the true
    parameters (the simplified sim "knows each deployment's exact type"),
    a monthly arrival/death schedule, greedy admission below 1.1*capacity,
    and BM = max over months of the admitted i^x mass.
  * ``rejection_q`` — the importance distribution q(I_i) of the paper's
    bucket-rejection scheme (Prop. 6), kept for fidelity.
  * ``make_importance_plan`` — the estimator actually run: stratified
    allocation over the same buckets (probe many cheap BM values, estimate
    p(I_i), then fill per-bucket quotas and weight runs by p_i/n_i).
  * ``simulate_plan`` / ``estimate_from_plan`` — run every selected seed
    through ``run_keyed_batch`` and combine the metrics with the
    stratified weights.
  * ``stream_badness`` / ``make_trace_ensemble_plan`` /
    ``simulate_trace_plan`` — the trace-replay analogue: replay is
    arrival-deterministic per trace, so the BM bucketing moves from run
    seeds to *traces*.

PyTorch counterpart of ``repro.sim.importance``. Plans hold run **seeds**
where the JAX package holds PRNG keys (the fields keep their names). The
point-mass curves are plain PyTorch ``core.moments.moment_curves_fused`` on
the probe's device, a batch of probes at a time, as the JAX package
computes them outside any kernel. The greedy month schedule is a
sequential scan over every (step, arrival) slot of the stream — 35,040 at
``PAPER_FULL`` — so it runs on the host in numpy float32, vectorized over
the probe batch, in the JAX package's order of summation.

A probe draws its run's stream exactly as the run does: ``make_run``'s run
draws the stream first from ``torch.Generator(device).manual_seed(seed)``,
so the probe does the same on the same device (CUDA and CPU generators
differ: a plan is bound to its device). The simplified schedule's lifetime
clocks come from a second generator seeded from (seed, 99), the
counterpart of the JAX package's ``fold_in(k_scan, 99)``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.belief import GammaBelief
from ..core.moments import moment_curves_fused
from ..core.processes import F32, DeploymentParams
from ..device import canonical_device, resolve_device, visible_devices
from ..obs.log import get_logger
from .core import (ArrivalSource, ArrivalStream, SimConfig,
                   draw_arrival_stream, stream_config, tree_to)
from .metrics import sla_failure_rate, weighted_mean
from .simulator import (RunMetrics, _seed_word, _tree_map, run_keyed_batch,
                        split_seeds)

log = get_logger(__name__)

HOURS_PER_MONTH = 730.0
#: the lifetime clocks' generator: seeded from (run seed, 99)
_LIFE_STREAM = 99


def _point_mass(params, k=1e6) -> GammaBelief:
    return GammaBelief(
        mu_a=params.mu * k, mu_b=torch.full_like(params.mu, k),
        lam_a=params.lam * k, lam_b=torch.full_like(params.lam, k),
        sig_a=params.sig * k, sig_b=torch.full_like(params.sig, k),
    )


def life_generator(seed: int, device) -> torch.Generator:
    """The generator of a run seed's simplified-schedule lifetime clocks."""
    return torch.Generator(device=device).manual_seed(
        _seed_word(seed, _LIFE_STREAM))


def point_mass_ix(stream: ArrivalStream, cfg: SimConfig,
                  grid: torch.Tensor) -> torch.Tensor:
    """Def. 5's i^x of every (step, arrival) slot of a stream ([..., T, A]
    leaves, flattened to [..., T*A]): the largest E[L] + sqrt(99 V[L]) over
    the grid under point-mass beliefs at the true parameters; 0 where no
    arrival occurs."""
    lead = tuple(stream.c0.shape[:-2])
    t_steps, a_max = stream.c0.shape[-2:]
    flat = lambda x: x.reshape(-1)
    params = DeploymentParams(*map(flat, stream.params))
    curves = moment_curves_fused(_point_mass(params), flat(stream.c0),
                                 grid.to(stream.c0.device), cfg.priors,
                                 d_points=8)
    i_x = torch.amax(curves.EL + torch.sqrt(99.0 * curves.VL), dim=-1)
    occurs = (torch.arange(a_max, device=stream.c0.device)
              < stream.n_arrivals[..., None])
    return torch.where(flat(occurs), i_x, 0.0).reshape(*lead, t_steps * a_max)


def greedy_schedule(i_x: np.ndarray, maxlife: np.ndarray, occurs: np.ndarray,
                    cfg: SimConfig) -> np.ndarray:
    """Def. 5's simplified schedule of B streams at once: every (step,
    arrival) slot j in order (arrival hour ``(j // A) * dt``, death hour
    that plus ``maxlife``) is admitted while its arrival month's admitted
    mass is below 1.1 capacity, adding its i^x to every month it lives in;
    BM is the largest month's mass. ``i_x``, ``maxlife``, ``occurs`` are
    [B, T*A]; float32 throughout, in the JAX package's order of summation
    (a month's mass is summed over slots in order). Returns [B] float32."""
    cfg = stream_config(cfg)
    i_x = np.asarray(i_x, np.float32)
    maxlife = np.asarray(maxlife, np.float32)
    occurs = np.asarray(occurs, bool)
    b, n_dep = i_x.shape
    a_max = n_dep // cfg.n_steps
    arr_hours = np.repeat(np.arange(cfg.n_steps, dtype=np.float32)
                          * np.float32(cfg.dt), a_max)
    per_month = np.float32(HOURS_PER_MONTH)
    n_months = int(np.ceil(cfg.horizon_hours / HOURS_PER_MONTH))
    m_arr = np.floor(arr_hours / per_month).astype(np.int64)
    # the JAX package casts to int32 as XLA does: saturating, NaN to 0 (a
    # lifetime clock of 1/(delta mu) at mu ~ 1e-19 overflows even int64)
    die = np.ceil((arr_hours[None, :] + maxlife) / per_month)
    m_die = np.where(np.isnan(die), 0.0, np.clip(
        die, -2.0**31, 2.0**31 - 1)).astype(np.int64)
    months = np.arange(n_months)
    thresh = np.float32(1.1 * cfg.capacity)
    mass = np.zeros((b, n_months), np.float32)
    rows = np.arange(b)
    zero = np.float32(0.0)
    # a slot no stream's arrival fills changes no month: skip it
    for j in np.nonzero(occurs.any(axis=0))[0]:
        ma = m_arr[j]
        # paper-literal gate: admit while the *current* mass is below the
        # threshold — the admitted deployment may overshoot it, which is what
        # spreads BM across the paper's buckets
        accept = occurs[:, j] & (mass[rows, ma] < thresh)
        live = accept[:, None] & (months >= ma) & (months < m_die[:, j, None])
        mass += np.where(live, i_x[:, j, None], zero)
    return mass.max(axis=1)


def _lifetimes(gens: Sequence[torch.Generator], mu: torch.Tensor,
               cfg: SimConfig) -> torch.Tensor:
    """[B, n] max-lifetime clocks Exp(1) / (delta mu), stream b's from
    ``gens[b]``."""
    expo = torch.stack([
        torch.empty(mu.shape[-1], dtype=F32, device=mu.device).exponential_(
            generator=g) for g in gens])
    return expo / (cfg.priors.delta * mu)


def _batch_badness(life_gens: Sequence[torch.Generator],
                   streams: ArrivalStream, cfg: SimConfig,
                   grid: torch.Tensor) -> np.ndarray:
    """BM of a stacked batch of B streams ([B, T, A] leaves); [B] float32."""
    b = streams.c0.shape[0]
    i_x = point_mass_ix(streams, cfg, grid)
    maxlife = _lifetimes(life_gens, streams.params.mu.reshape(b, -1), cfg)
    a_max = streams.c0.shape[-1]
    occurs = (torch.arange(a_max, device=streams.c0.device)
              < streams.n_arrivals[..., None]).reshape(b, -1)
    return greedy_schedule(i_x.cpu().numpy(), maxlife.cpu().numpy(),
                           occurs.cpu().numpy(), cfg)


def _stack(streams: Sequence[ArrivalStream]) -> ArrivalStream:
    return _tree_map(lambda *xs: torch.stack(xs), *streams)


def _as_list(streams) -> list:
    """A list of [T, A] streams from a list or a stacked [R] batch."""
    if isinstance(streams, ArrivalStream) and streams.c0.ndim == 3:
        return [_tree_map(lambda x: x[r], streams)
                for r in range(streams.c0.shape[0])]
    return list(streams)


def stream_badness(life_gen: torch.Generator, stream: ArrivalStream,
                   cfg: SimConfig, grid) -> float:
    """Def.-5 badness of a *given* pre-drawn arrival stream ([T, A] leaves).

    ``life_gen`` draws only the simplified schedule's max-lifetime clocks;
    the arrival side (who arrives when, how large, with what true
    parameters) is entirely the stream's. This is the primitive trace-level
    bucketing builds on: replay streams are arrival-deterministic per trace,
    so BM computed here ranks *traces*, not run seeds.

    ``cfg`` may be a ``FleetConfig``: the simplified greedy schedule admits
    against the fleet's *total* capacity (``stream_config``), because BM
    describes the arrival-side tail of the whole pre-drawn stream, before
    any routing.
    """
    cfg = stream_config(cfg)
    stream = tree_to(stream, life_gen.device)
    grid = torch.as_tensor(grid, dtype=F32, device=life_gen.device)
    return float(_batch_badness([life_gen], _stack([stream]), cfg, grid)[0])


def _probe_streams(seeds, cfg: SimConfig, device,
                   source: Optional[ArrivalSource]) -> ArrivalStream:
    """The streams the runs of ``seeds`` draw first, stacked [B, T, A]."""
    draw = (draw_arrival_stream if source is None else
            lambda g, c: source.stream(g, c))
    return _stack([draw(torch.Generator(device=device).manual_seed(int(s)),
                        cfg) for s in seeds])


def _probe(seeds, cfg: SimConfig, grid, source, devices) -> np.ndarray:
    """BM of the runs of ``seeds`` ([B] float32), one batch: split into
    contiguous chunks over ``devices`` when B divides their count, else on
    the first (as the JAX package's probe falls back). A probe's BM does
    not depend on the probes beside it, so the split changes no bit."""
    n_dev = len(devices)
    if n_dev > 1 and len(seeds) % n_dev == 0:
        per = len(seeds) // n_dev
        return np.concatenate([
            _probe(seeds[i * per:(i + 1) * per], cfg, grid, source, [d])
            for i, d in enumerate(devices)])
    device = devices[0]
    streams = _probe_streams(seeds, cfg, device, source)
    return _batch_badness([life_generator(s, device) for s in seeds],
                          streams, cfg, grid.to(device))


def badness_measure(seed: int, cfg: SimConfig, grid,
                    source: Optional[ArrivalSource] = None, *,
                    device="cuda") -> float:
    """BM(r) for the run whose arrival stream is drawn from ``seed`` (Def. 5),
    on ``device`` (the card unless the caller passes ``"cpu"``).

    Draws the stream as ``make_run``'s run does on the same device, so the
    BM describes the same arrival stream the expensive simulation will see.
    ``source`` selects the arrival backend (default: prior sampling); with a
    *single* trace-replay source the stream — and therefore BM — is
    seed-independent, so stratification degenerates to a single bucket:
    bucket a trace ensemble instead via ``make_trace_ensemble_plan``.
    """
    device = resolve_device(device)
    cfg = stream_config(cfg)
    grid = torch.as_tensor(grid, dtype=F32, device=device)
    return float(_probe([seed], cfg, grid, source, [device])[0])


def rejection_q(p: Sequence[float], p_r: Sequence[float]) -> np.ndarray:
    """Importance distribution q(I_i) of the paper's rejection scheme (Prop. 6).

    ``p``: nominal bucket probabilities; ``p_r``: redraw probabilities (the
    top bucket must have p_r = 0). Buckets are ordered worst-last.
    """
    p = np.asarray(p, dtype=np.float64)
    p_r = np.asarray(p_r, dtype=np.float64)
    k = len(p)
    assert p_r[-1] == 0.0, "top bucket is never redrawn"
    q = np.zeros(k)
    for i in range(k):
        tail = p[i:].sum()  # P(union of buckets >= i)
        p_cond = p[i] / tail  # p(I_i | union_{k>=i} I_k)
        q[i] = p_cond * (1.0 - p_r[i]) / (1.0 - p_cond * p_r[i])
        for j in range(i):
            tail_j = p[j:].sum()
            pj = p[j] / tail_j
            q[i] *= (1.0 - pj) / (1.0 - pj * p_r[j])
    return q


def _stratify(bm: np.ndarray, capacity: float, quotas: Sequence[int],
              edges_frac: Sequence[float], runs_each: int = 1):
    """Bucket ``bm`` at ``edges_frac * capacity``; take up to ``quotas[i]``
    members of bucket i in order, each ``runs_each`` times at weight
    p_hat[i] / (members * runs_each). Returns (members, weights, buckets,
    p_hat), members and weights one entry a run."""
    edges = np.asarray(edges_frac) * capacity
    bucket = np.digitize(bm, edges)
    k_buckets = len(edges) + 1
    p_hat = np.array([(bucket == i).mean() for i in range(k_buckets)])
    sel, sel_w, sel_b = [], [], []
    for i in range(k_buckets):
        idx = np.nonzero(bucket == i)[0][: quotas[i]]
        if len(idx) == 0:
            continue
        w = p_hat[i] / (len(idx) * runs_each)
        for j in idx:
            sel.extend([int(j)] * runs_each)
            sel_w.extend([w] * runs_each)
            sel_b.extend([i] * runs_each)
    return (np.asarray(sel, np.int64), np.asarray(sel_w),
            np.asarray(sel_b, np.int64), p_hat)


class ImportancePlan(NamedTuple):
    keys: np.ndarray       # [R] int64 run seeds to simulate (full runs)
    weights: np.ndarray    # [R] stratified weights (sum to ~1)
    buckets: np.ndarray    # [R] bucket index per selected run
    p_bucket: np.ndarray   # [K] estimated nominal bucket probabilities
    bm_probe: np.ndarray   # [n_probe] BM values of the probe (diagnostics)


def plan_from_badness(bm: np.ndarray, seeds, cfg: SimConfig,
                      quotas: Sequence[int] = (8, 8, 8),
                      edges_frac: Sequence[float] = (1.25, 1.5)
                      ) -> ImportancePlan:
    """The stratified plan over probed seeds whose BM values are ``bm``."""
    cfg = stream_config(cfg)
    bm = np.asarray(bm)
    sel, w, b, p_hat = _stratify(bm, cfg.capacity, quotas, edges_frac)
    log.debug("importance plan: %d runs over buckets=%s p_hat=%s "
              "(probed %d)", len(sel),
              np.bincount(b, minlength=len(p_hat)).tolist(),
              np.round(p_hat, 4).tolist(), len(bm))
    return ImportancePlan(keys=np.asarray(seeds, np.int64)[sel], weights=w,
                          buckets=b, p_bucket=p_hat, bm_probe=bm)


def make_importance_plan(
    seed: int,
    cfg: SimConfig,
    grid,
    quotas: Sequence[int] = (8, 8, 8),
    edges_frac: Sequence[float] = (1.25, 1.5),
    n_probe: int = 512,
    probe_batch: int = 64,
    source: Optional[ArrivalSource] = None,
    *,
    device="cuda",
    devices=None,
) -> ImportancePlan:
    """Stratified importance plan over BM buckets, probed on ``device`` (the
    card unless the caller passes ``"cpu"``), each batch of probes split
    over ``devices`` (default: the visible devices of ``device``'s kind,
    ``device.visible_devices``; see ``_probe``). The plan is the same over
    any number of devices of one kind.

    Bucket edges are ``edges_frac * capacity`` (the paper used 25k/30k at
    c = 20k, i.e. 1.25c / 1.5c). Probes ``n_probe`` run seeds derived from
    ``seed`` (``split_seeds``) in batches of ``probe_batch`` to estimate
    p(I_i); selects runs until each bucket quota is met (buckets that the
    probe never hits keep weight 0).

    With a ``FleetConfig`` the bucket edges scale with the fleet's *total*
    capacity and BM reduces over clusters (see ``stream_badness``), so the
    plan's seeds feed ``make_fleet_run`` runs unchanged.
    """
    device = resolve_device(device)
    devices = (visible_devices(device) if devices is None
               else [canonical_device(d) for d in devices])
    cfg = stream_config(cfg)
    grid = torch.as_tensor(grid, dtype=F32, device=device)
    seeds = split_seeds(seed, n_probe)
    bm = np.concatenate([
        _probe(seeds[i:i + probe_batch], cfg, grid, source, devices)
        for i in range(0, n_probe, probe_batch)])
    return plan_from_badness(bm, seeds, cfg, quotas, edges_frac)


def simulate_plan(run_fn, plan: ImportancePlan, policy, *,
                  devices=None) -> RunMetrics:
    """Simulate every selected run of a plan in one batch
    (``run_keyed_batch``); per-run ``RunMetrics`` in plan order, to
    combine with ``plan.weights`` via ``estimate_from_plan``."""
    return run_keyed_batch(run_fn, [int(s) for s in plan.keys], policy,
                           devices=devices)


# ---------------------------------------------------------------------------
# Trace-ensemble importance sampling
#
# Replay is arrival-stream-deterministic per trace: every run seed sees the
# same arrivals, so seed-level BM bucketing collapses to one bucket. The
# arrival-side tail lives *across* traces, so stratification moves up a
# level: bucket the ensemble by per-trace BM, oversample the bad traces, and
# spread each bucket's probability mass over its selected (trace, run-seed)
# pairs.
# ---------------------------------------------------------------------------


class TraceEnsemblePlan(NamedTuple):
    trace_idx: np.ndarray  # [R] ensemble index of each selected run's trace
    keys: np.ndarray       # [R] int64 run seeds (within-run randomness)
    weights: np.ndarray    # [R] stratified weights (sum to ~1)
    buckets: np.ndarray    # [R] bucket index per selected run
    p_bucket: np.ndarray   # [K] estimated bucket probabilities over traces
    bm_trace: np.ndarray   # [n_traces] BM per ensemble member (diagnostics)


def trace_plan_from_badness(bm: np.ndarray, run_seeds, cfg: SimConfig, *,
                            quotas: Sequence[int] = (8, 4, 4),
                            edges_frac: Sequence[float] = (1.25, 1.5),
                            runs_per_trace: int = 1) -> TraceEnsemblePlan:
    """The stratified plan over an ensemble whose per-trace BM values are
    ``bm``; ``run_seeds`` [n_traces, runs_per_trace]."""
    cfg = stream_config(cfg)
    bm = np.asarray(bm)
    run_seeds = np.asarray(run_seeds, np.int64).reshape(len(bm),
                                                        runs_per_trace)
    sel, w, b, p_hat = _stratify(bm, cfg.capacity, quotas, edges_frac,
                                 runs_per_trace)
    rep = np.tile(np.arange(runs_per_trace), len(sel) // runs_per_trace)
    log.debug("trace-ensemble plan: %d runs over buckets=%s p_hat=%s",
              len(sel), np.bincount(b, minlength=len(p_hat)).tolist(),
              np.round(p_hat, 4).tolist())
    return TraceEnsemblePlan(trace_idx=sel, keys=run_seeds[sel, rep],
                             weights=w, buckets=b, p_bucket=p_hat,
                             bm_trace=bm)


def make_trace_ensemble_plan(
    seed: int,
    cfg: SimConfig,
    grid,
    streams,
    *,
    quotas: Sequence[int] = (8, 4, 4),
    edges_frac: Sequence[float] = (1.25, 1.5),
    runs_per_trace: int = 1,
    probe_batch: int = 64,
) -> TraceEnsemblePlan:
    """Stratified plan over a *trace ensemble*'s BM buckets.

    ``streams`` are pre-built arrival streams (``traces.trace_to_stream``
    output), one per ensemble member, as a list or a stacked [R] batch, on
    one device; each is an iid draw of the arrival process, so the empirical
    bucket frequencies estimate p(I_i) exactly as the seed probe does in
    ``make_importance_plan``. Up to ``quotas[i]`` traces are selected per
    bucket and each gets ``runs_per_trace`` independent run seeds; a run's
    weight is ``p_bucket / (n_selected_traces * runs_per_trace)``.

    ``seed`` derives two seeds (``split_seeds``): the first the members'
    lifetime-clock seeds, the second the run seeds. The ensemble is probed
    ``probe_batch`` members at a time.
    """
    cfg = stream_config(cfg)
    streams = _as_list(streams)
    n_traces = len(streams)
    if n_traces == 0:
        raise ValueError("trace ensemble is empty")
    device = streams[0].c0.device
    grid = torch.as_tensor(grid, dtype=F32, device=device)
    s_bm, s_run = split_seeds(seed, 2)
    life = [torch.Generator(device=device).manual_seed(s)
            for s in split_seeds(s_bm, n_traces)]
    bm = np.concatenate([
        _batch_badness(life[i:i + probe_batch],
                       _stack(streams[i:i + probe_batch]), cfg, grid)
        for i in range(0, n_traces, probe_batch)])
    run_seeds = split_seeds(s_run, n_traces * runs_per_trace)
    return trace_plan_from_badness(bm, run_seeds, cfg, quotas=quotas,
                                   edges_frac=edges_frac,
                                   runs_per_trace=runs_per_trace)


def simulate_trace_plan(run_fn, plan: TraceEnsemblePlan, streams, policy, *,
                        devices=None) -> RunMetrics:
    """Simulate a trace-ensemble plan in one batch: each selected run seed
    with its trace's pre-built stream (``run_keyed_batch``'s ``streams``).
    Returns per-run metrics in plan order; combine with ``plan.weights``
    via ``estimate_from_plan``."""
    streams = _as_list(streams)
    batch = _stack([streams[i] for i in plan.trace_idx])
    return run_keyed_batch(run_fn, [int(s) for s in plan.keys], policy,
                           streams=batch, devices=devices)


def estimate_from_plan(plan, metrics: RunMetrics) -> dict:
    """Stratified estimates from a simulated plan (``ImportancePlan`` or
    ``TraceEnsemblePlan`` — only the weights are consumed): weighted
    utilization and the aggregate SLA failure rate (rare bad runs count at
    their true probability). ``metrics`` may equally be a ``FleetMetrics``
    batch."""
    w = plan.weights
    host = lambda x: x.detach().cpu().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x)
    return {
        "utilization": weighted_mean(host(metrics.utilization), w),
        "sla_fail": sla_failure_rate(host(metrics.failed_requests),
                                     host(metrics.total_requests),
                                     weights=w),
        "n_runs": int(len(w)),
        "weight_mass": float(np.sum(w)),
    }
