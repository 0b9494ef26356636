"""Monte-Carlo cluster simulator (paper §5): a step loop over the admission
core.

Deployments live in a fixed slot array. Each step of length ``dt`` hours:

  1. core deaths (binomial thinning) + spontaneous shutdown (M process)
  2. scale-out requests; granted greedily in slot order while the cluster has
     capacity, otherwise logged as SLA failures (entire request fails)
  3. belief updates from the observed events (conjugate, core.belief)
  4. arrivals (Poisson, capped at ``max_arrivals`` per step) admitted by the
     policy via core.policies.admit_sequential, then placed into free slots

Steps 1–3 are the admission core's ``apply_events``, step 4 its
``decide_batch``. Arrival parameters are pre-drawn before the loop by an
``ArrivalSource``. The loop is blocked by ``agg_refresh_steps``: the cluster
aggregate moment curves are recomputed once per block (through
``cfg.agg_backend``; the aggregate kernel on the card) and maintained
incrementally inside the block by folding placed candidates' curves.

PyTorch counterpart of ``repro.sim.simulator.make_run``, ``run_keyed_batch``
and ``run_batch``, where the JAX package's ``lax.scan`` is a Python loop and
its ``vmap`` over runs a leading run axis written out: a batch of R runs
steps R slot tables together, so one step's ~400 launches serve all R runs.
Run r of a batch has the bits of ``make_run`` alone on its seed: its
arrivals and events come from its own ``torch.Generator``, drawn in the
order a single run draws them (four small draws a run a step), and the
step's arithmetic gives each run the bits it gets alone (``sim.core``).
The loop never reads a device value back to the host, so on the card it
only enqueues work.

**Fleet mode** (paper §2's provider view: dispatch *then* admit):
``make_fleet_run`` steps ``FleetConfig.n_clusters`` heterogeneous clusters
with the same core functions over a cluster axis ([C, S] slot tables,
[R, C, S] for a batch of R fleet runs; ``capacity`` the [C] vector). A
``sim.routing.Router`` maps each fleet-wide arrival to a target cluster
*before* ``admit_sequential`` runs there; arrivals no cluster would take
are counted as rejected-by-all. A step evaluates the fleet-wide arrivals'
curves once (one row-kernel launch) and hands them to every cluster as
``expand`` views; a refresh sums every cluster's table in one aggregate
launch. Cluster 0 draws its events from the run's own generator, after
the stream, as ``make_run`` draws them, so a fleet of one equals
``make_run`` bit for bit; clusters 1..C-1 and the router draw from
generators derived from (the run's seed, c) (``fleet_generators``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.belief import GammaBelief
from ..core.moments import MomentCurves
from ..core.policies import PolicyParams
from ..core.processes import F32, DeploymentParams, StepEvents
from .core import (ArrivalSource, ArrivalStream, FleetConfig,
                   PriorArrivalSource, SimConfig, SimState, StepOutcome,
                   _validate_fleet_config, make_admission_core,
                   stream_config, tree_to)

# where a device mesh will be ported
_ROADMAP_MESH = "is not ported yet: ROADMAP.md, Queue A, item 5 (mesh)"


class RunMetrics(NamedTuple):
    """A run's metrics: 0-d leaves, traces [T]; a batch's have a leading
    [R] (traces [R, T])."""

    utilization: torch.Tensor     # time-average active cores / capacity
    failure_rate: torch.Tensor    # failed scale-out requests / total requests
    total_requests: torch.Tensor
    failed_requests: torch.Tensor
    arrivals_accepted: torch.Tensor
    arrivals_rejected: torch.Tensor
    slot_overflow: torch.Tensor   # arrivals lost to slot-array exhaustion
    n_departed: torch.Tensor      # deployments that died over the whole run
    alive_end: torch.Tensor       # deployments still alive at the horizon
    util_trace: torch.Tensor      # [T] active cores after each step
    fail_trace: torch.Tensor      # [T] failed requests per step


class FleetMetrics(NamedTuple):
    """Fleet-level reductions plus the per-cluster ``RunMetrics``.

    The scalar fields mirror ``RunMetrics`` reduced over the cluster axis
    (capacity-weighted utilization; summed counts) so fleet runs drop into
    any consumer of run-level metrics (calibration, ``sim.metrics``).
    ``per_cluster`` carries the [C]-leading per-cluster metrics
    (``util_trace`` is [C, T]). A batch of R fleet runs puts [R] in front
    of every leaf.
    """

    utilization: torch.Tensor     # total core-hours / (horizon * total capacity)
    failure_rate: torch.Tensor    # summed failures / summed requests
    total_requests: torch.Tensor
    failed_requests: torch.Tensor
    arrivals_accepted: torch.Tensor
    arrivals_rejected: torch.Tensor  # per-cluster rejections + rejected_by_all
    rejected_by_all: torch.Tensor    # arrivals the router could place nowhere
                                     # (the threshold cascade's sentinel; 0
                                     # for single-target routers)
    slot_overflow: torch.Tensor
    util_trace: torch.Tensor      # [T] fleet active cores after each step
    fail_trace: torch.Tensor      # [T] fleet failed requests per step
    per_cluster: RunMetrics       # a [C] axis on every field


def _run_metrics(cfg: SimConfig, slots: SimState, util_trace,
                 fail_trace, horizon_hours=None, capacity=None
                 ) -> RunMetrics:
    """Assemble ``RunMetrics`` from the final slot-table accumulators.
    Shared by ``make_run`` and the online engine (which passes the hours
    its ticks covered so far), so "final metrics" means the same arithmetic
    in both. A fleet passes its [C] ``capacity``. The divisor is a tensor
    either way: CUDA divides by a Python number as a multiply by its
    reciprocal, so a Python capacity would round otherwise than a fleet's
    [C] one."""
    horizon = cfg.horizon_hours if horizon_hours is None else horizon_hours
    cap = cfg.capacity if capacity is None else capacity
    denom = torch.as_tensor(horizon * cap, dtype=F32,
                            device=slots.core_hours.device)
    return RunMetrics(
        utilization=slots.core_hours / denom,
        failure_rate=slots.fail_requests
        / torch.clamp(slots.total_requests, min=1.0),
        total_requests=slots.total_requests,
        failed_requests=slots.fail_requests,
        arrivals_accepted=slots.arr_accepted,
        arrivals_rejected=slots.arr_rejected,
        slot_overflow=slots.slot_overflow,
        n_departed=slots.n_departed,
        alive_end=torch.sum(slots.alive.to(F32), dim=-1),
        util_trace=util_trace,
        fail_trace=fail_trace,
    )


def _fleet_metrics(cfg: SimConfig, caps: torch.Tensor, slots: SimState,
                   util_trace, fail_trace, rej_all,
                   horizon_hours=None) -> FleetMetrics:
    """Assemble ``FleetMetrics`` from per-cluster slot-table accumulators
    ([C] leaves, [R, C] for a batch; ``util_trace``/``fail_trace`` [C, T]
    or [R, C, T]): sums over the cluster axis. Shared by
    ``make_fleet_run`` and the online engine."""
    horizon = cfg.horizon_hours if horizon_hours is None else horizon_hours
    per_cluster = _run_metrics(cfg, slots, util_trace, fail_trace,
                               horizon_hours=horizon, capacity=caps)
    total = lambda x: torch.sum(x, dim=-1)
    tot_req, tot_fail = total(slots.total_requests), total(slots.fail_requests)
    return FleetMetrics(
        utilization=total(slots.core_hours) / (horizon * torch.sum(caps)),
        failure_rate=tot_fail / torch.clamp(tot_req, min=1.0),
        total_requests=tot_req,
        failed_requests=tot_fail,
        arrivals_accepted=total(slots.arr_accepted),
        arrivals_rejected=total(slots.arr_rejected) + rej_all,
        rejected_by_all=rej_all,
        slot_overflow=total(slots.slot_overflow),
        util_trace=torch.sum(util_trace, dim=-2),
        fail_trace=torch.sum(fail_trace, dim=-2),
        per_cluster=per_cluster,
    )


def _accumulate_step(slots: SimState, out: StepOutcome, n_acc, n_rej,
                     dt: float):
    """Fold one step's outcome into the slot-table metric accumulators;
    returns (slots, util_end)."""
    util_end = torch.sum(slots.cores * slots.alive.to(F32), dim=-1)
    slots = slots._replace(
        core_hours=slots.core_hours + util_end * dt,
        fail_requests=slots.fail_requests + out.failed,
        total_requests=slots.total_requests + out.n_requests,
        arr_accepted=slots.arr_accepted + n_acc,
        arr_rejected=slots.arr_rejected + n_rej,
        n_departed=slots.n_departed + out.departed,
    )
    return slots, util_end


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of (nested) NamedTuples."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(*(_tree_map(fn, *xs) for xs in zip(*trees)))


def _steps(stream: ArrivalStream) -> list:
    """The stream's per-step views: one ``ArrivalStream`` of [A] leaves per
    step (one ``unbind`` per leaf instead of an index per leaf per step)."""
    def unbind(tree):
        if isinstance(tree, torch.Tensor):
            return tree.unbind(0)
        return [type(tree)(*xs) for xs in zip(*map(unbind, tree))]
    return unbind(stream)


def _run_stream(source: ArrivalSource, cfg: SimConfig, gens: list,
                batch: bool, stream: Optional[ArrivalStream],
                device) -> ArrivalStream:
    """A run's arrival stream on ``device``, its step axis first: ``stream``
    as given ([R, T, ...] moved to [T, R, ...] for a batch, so that a
    step's slice is [R, A]), or drawn by ``source`` from each run's
    generator in ``gens``."""
    if stream is not None:
        stream = tree_to(stream, device)
        if batch:
            stream = _tree_map(lambda x: x.movedim(0, 1).contiguous(), stream)
        return stream
    if batch:
        return _tree_map(lambda *xs: torch.stack(xs, dim=1),
                         *(source.stream(g, cfg) for g in gens))
    return source.stream(gens[0], cfg)


def _generator(gen_or_seed, device: torch.device) -> torch.Generator:
    if isinstance(gen_or_seed, torch.Generator):
        if gen_or_seed.device.type != device.type:
            raise ValueError(f"generator is on {gen_or_seed.device}, the run "
                             f"on {device}")
        return gen_or_seed
    return torch.Generator(device=device).manual_seed(int(gen_or_seed))


def _is_batch(gen_or_seeds) -> bool:
    """A sequence (or 1-d array) of seeds or generators is a batch; one
    seed or generator is a single run."""
    if isinstance(gen_or_seeds, (torch.Tensor, np.ndarray)):
        return gen_or_seeds.ndim == 1
    return isinstance(gen_or_seeds, (list, tuple))


def _seed_word(*entropy) -> int:
    """A ``torch.Generator`` seed from ``numpy.random.SeedSequence``:
    its first 64-bit word, shifted right by one bit."""
    word = np.random.SeedSequence([int(x) for x in entropy]).generate_state(
        1, np.uint64)[0]
    return int(word >> np.uint64(1))


def split_seeds(seed: int, n_runs: int) -> list:
    """``n_runs`` run seeds derived from ``seed``: the first ``n_runs``
    64-bit words of ``numpy.random.SeedSequence(seed)``, each shifted right
    by one bit to fit a ``torch.Generator`` seed. Deterministic, and a
    prefix of the seeds for a larger ``n_runs``; it stands in for the JAX
    package's ``jax.random.split``, whose keys it does not reproduce."""
    words = np.random.SeedSequence(int(seed)).generate_state(n_runs,
                                                             np.uint64)
    return [int(w >> np.uint64(1)) for w in words]


def _one_device(devices) -> None:
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            f"a batch over {len(devices)} devices " + _ROADMAP_MESH)


def make_run(cfg: SimConfig, horizon_grid, policy_kind: int,
             arrival_source: ArrivalSource | None = None,
             record_decisions: bool = False, *, device="cuda"):
    """Build the simulator for a fixed policy *kind* on ``device`` (the card
    unless the caller passes ``"cpu"``; raises when CUDA is missing).

    Returns ``run(gen_or_seed, policy, stream=None, events=None)``:
    ``gen_or_seed`` is a ``torch.Generator`` on the run's device or an int
    seed; ``stream`` (an ``ArrivalStream``) replaces the source's draw;
    ``events`` (a per-step sequence of ``StepEvents``) replaces the
    per-step event sampling — the counterpart of ``stream=`` that lets a
    test drive the port with another package's draws. The run returns
    ``RunMetrics``, or ``(RunMetrics, accept [T, A])`` with
    ``record_decisions=True``. With ``cfg.telemetry`` the final
    ``obs.counters.TelemetryState`` rider is one more element (``(metrics,
    tel)`` or ``(metrics, accept, tel)``); decisions and metrics are
    bit-identical with the rider on or off.

    A batch: ``gen_or_seed`` a sequence of R seeds or generators (or a 1-d
    array of seeds), ``policy`` leaves 0-d (shared) or [R], ``stream`` a
    stacked batch with a leading [R] (leaves [R, T, A], as the JAX package
    stacks them), ``events`` per step with [R, S] leaves. The batch's
    metrics have a leading [R] (``accept`` is [R, T, A]), and run r equals
    the run alone on its seed bit for bit (its rider: leaves with a leading
    [R]).

    The loop is blocked by ``cfg.agg_refresh_steps`` (= K): the aggregate
    curves are recomputed from the slot array once per block and, inside a
    block, each *placed* candidate's curves are folded into the running sums,
    so a decision costs O(grid) whatever the occupancy.
    """
    core = make_admission_core(cfg, horizon_grid, policy_kind, device=device)
    device = core.device
    source = PriorArrivalSource() if arrival_source is None else arrival_source
    k_refresh = cfg.agg_refresh_steps
    n_steps, a_max = cfg.n_steps, cfg.max_arrivals
    arange_a = torch.arange(a_max, device=device)

    def run(gen_or_seed, policy: PolicyParams,
            stream: Optional[ArrivalStream] = None,
            events: Optional[Sequence[StepEvents]] = None):
        batch = _is_batch(gen_or_seed)
        if batch:
            gen = [_generator(g, device) for g in gen_or_seed]
            runs = len(gen)
        else:
            gen, runs = _generator(gen_or_seed, device), None
        policy = tree_to(policy, device)
        stream = _run_stream(source, cfg, gen if batch else [gen], batch,
                             stream, device)
        if events is not None and len(events) != n_steps:
            raise ValueError(f"events has {len(events)} steps, the run "
                             f"{n_steps}")
        cs = core.init(runs)
        util_trace, fail_trace, accepts = [], [], []
        rows = _steps(core.candidate_rows(stream))
        for t, stream_t in enumerate(_steps(stream)):
            if t % k_refresh == 0:
                cs = core.refresh_aggregates(cs)
            if events is None:
                cs, out = core.apply_events(gen, cs)
            else:
                cs, out = core.observe_events(cs, tree_to(events[t], device))

            # 4. arrivals, admitted against the maintained aggregate ------
            valid = arange_a < stream_t.n_arrivals[..., None]
            cand = core.candidates(rows[t])
            cs, accept = core.decide_batch(policy, cs, out.util, cand,
                                           stream_t, valid)
            n_acc = torch.sum(accept.to(F32), dim=-1)
            n_rej = torch.sum(valid.to(F32), dim=-1) - n_acc
            slots, util_end = _accumulate_step(cs.slots, out, n_acc, n_rej,
                                               cfg.dt)
            cs = cs._replace(slots=slots)
            util_trace.append(util_end)
            fail_trace.append(out.failed)
            accepts.append(accept)
        metrics = _run_metrics(cfg, cs.slots, torch.stack(util_trace, dim=-1),
                               torch.stack(fail_trace, dim=-1))
        result = (metrics,)
        if record_decisions:
            result += (torch.stack(accepts, dim=-2),)
        if cfg.telemetry:
            result += (cs.tel,)
        return result if len(result) > 1 else metrics

    return run


def run_keyed_batch(run_fn, seeds, policy: PolicyParams, *,
                    streams: Optional[ArrivalStream] = None,
                    devices=None) -> RunMetrics:
    """Simulate an explicit batch of R run seeds (or generators) with
    ``run_fn`` (a ``make_run`` run) in one batched loop; returns
    ``RunMetrics`` with a leading [R]. ``policy`` is shared (0-d leaves) or
    one for each run ([R] leaves); ``streams`` (optional) is a stacked [R]
    batch of ``ArrivalStream``s, one for each run. The port runs on one
    card: ``devices`` naming more than one raises."""
    _one_device(devices)
    return run_fn(list(seeds), policy, stream=streams)


def run_batch(run_fn, seed: int, policy: PolicyParams, n_runs: int, *,
              devices=None) -> RunMetrics:
    """A batch of ``n_runs`` independent runs whose seeds ``split_seeds``
    derives from ``seed``; see ``run_keyed_batch``."""
    return run_keyed_batch(run_fn, split_seeds(seed, n_runs), policy,
                           devices=devices)


# ---------------------------------------------------------------------------
# Fleet mode: a cluster axis over the same step machinery.
# ---------------------------------------------------------------------------


def fleet_generators(gen: torch.Generator, n_clusters: int) -> list:
    """The C + 1 generators of a fleet run on ``gen``: cluster 0 draws from
    ``gen`` itself (so a fleet of one draws ``make_run``'s events), clusters
    1..C-1 and then the router (index C) from generators seeded by
    ``numpy.random.SeedSequence([gen.initial_seed(), c])``. Deriving them
    draws nothing from ``gen``. The counterpart of the JAX package's
    ``_cluster_step_keys`` (cluster 0 the undiverted key, ``fold_in(key,
    c)`` for the others and ``fold_in(key, C)`` for the router)."""
    seed = gen.initial_seed()
    return [gen] + [
        torch.Generator(device=gen.device).manual_seed(_seed_word(seed, c))
        for c in range(1, n_clusters + 1)]


def _check_fleet_policy_capacity(policy: PolicyParams,
                                 fcfg: FleetConfig) -> None:
    """Fail fast on a mis-specified fleet policy: each cluster's ``decide``
    admits against ``policy.capacity``, so a scalar fleet-*total* capacity
    tiled to every cluster would let each cluster believe it owns the whole
    fleet's budget — calibration would then return plausible-looking but
    wildly over-optimistic thetas with no error. The port has no tracers:
    it checks at every call (one read of the capacity leaf)."""
    cap = getattr(policy, "capacity", None)
    if cap is None:
        return
    cap = (cap.detach().cpu().numpy() if isinstance(cap, torch.Tensor)
           else np.asarray(cap))
    target = np.asarray(fcfg.capacities, dtype=np.float64)
    ok = (cap.ndim == 0 or (cap.ndim <= 2 and cap.shape[-1:] == target.shape)
          ) and np.allclose(np.asarray(cap, np.float64), target, rtol=1e-5)
    if not ok:
        raise ValueError(
            f"policy capacity {cap} does not match FleetConfig.capacities "
            f"{fcfg.capacities}: each cluster admits against its OWN "
            "capacity. Build fleet policies with core.policies.fleet_policy"
            "(kind, capacities=fleet_cfg.capacities, ...); when tuning, pass "
            "such a closure as calibrate(..., policy_fn=...).")


def broadcast_policy(policy: PolicyParams, n_clusters: int,
                     runs: Optional[int] = None) -> PolicyParams:
    """Give every PolicyParams field a [C] cluster axis.

    Scalar fields are tiled (an ``expand`` view); fields already carrying
    the cluster axis (from ``core.policies.fleet_policy``) pass through
    unchanged, and with ``runs`` so do [runs, C] fields (one policy for
    each fleet run of a batch). Anything else is a shape error —
    per-cluster parameters must be built deliberately.
    """

    def bc(x):
        x = torch.as_tensor(x)
        if x.ndim == 0:
            return x.expand(n_clusters)
        if x.ndim == 1 and x.shape[0] == n_clusters:
            return x
        if runs is not None and tuple(x.shape) == (runs, n_clusters):
            return x
        raise ValueError(
            f"policy field has shape {tuple(x.shape)}; expected a scalar or "
            f"a [{n_clusters}]-vector (one entry per cluster)"
            + ("" if runs is None else
               f", or [{runs}, {n_clusters}] (one for each run)"))

    return PolicyParams(*map(bc, policy))


def _to_clusters(stream_t: ArrivalStream, n_c: int) -> ArrivalStream:
    """One step's fleet-wide arrivals ([..., A] leaves) as every cluster's
    ([..., C, A] ``expand`` views: no copy)."""
    ex = lambda x: x[..., None, :].expand(*x.shape[:-1], n_c, x.shape[-1])
    return ArrivalStream(
        params=DeploymentParams(*map(ex, stream_t.params)), c0=ex(stream_t.c0),
        bel=GammaBelief(*map(ex, stream_t.bel)),
        bel_alt=GammaBelief(*map(ex, stream_t.bel_alt)),
        n_arrivals=stream_t.n_arrivals[..., None].expand(
            *stream_t.n_arrivals.shape, n_c))


def _sample_tables(core, gens: list, slots: SimState) -> StepEvents:
    """One step's events of every slot table of ``slots`` ([C, S], or
    [R, C, S] taken as R C tables), table i's from ``gens[i]`` as a call on
    that table alone draws them."""
    lead = slots.cores.shape[:-1]
    if len(lead) == 1:
        return core.sample_events(gens, slots)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    ev = core.sample_events(gens, slots._replace(
        alive=flat(slots.alive), cores=flat(slots.cores),
        params=DeploymentParams(*map(flat, slots.params))))
    return StepEvents(*(x.reshape(*lead, -1) for x in ev))


def make_fleet_run(fcfg: FleetConfig, horizon_grid, policy_kind: int,
                   router=None, arrival_source: ArrivalSource | None = None,
                   record_decisions: bool = False, *, device="cuda"):
    """Build the fleet simulator on ``device`` (the card unless the caller
    passes ``"cpu"``): route, then admit per cluster.

    Returns ``run(gen_or_seed, policy, stream=None, events=None,
    route_draws=None) -> FleetMetrics``. ``policy`` is normally a
    ``core.policies.fleet_policy`` ([C] fields, per-cluster capacities and
    thresholds); a plain scalar ``PolicyParams`` is tiled to every cluster
    by ``broadcast_policy``, which is only meaningful for a homogeneous
    fleet — ``run`` fails fast when the policy's capacity does not match
    ``FleetConfig.capacities`` per cluster. ``stream`` replaces the
    source's fleet-wide draw (``stream_config(fcfg)``); ``events`` (a
    per-step sequence of ``StepEvents`` with [C, S] leaves) replaces every
    cluster's event sampling and ``route_draws`` (a per-step sequence of
    the router's ``draw`` results) the router's draws — the counterparts
    of ``stream=`` that let a test drive the port with another package's
    draws. With ``record_decisions=True`` the run returns
    ``(FleetMetrics, accept [T, C, A], assign [T, A])``; with
    ``fcfg.base.telemetry`` the final per-cluster rider (every leaf
    [C]-leading; ``n_routed`` across clusters is the routing count
    vector) is one more element.

    A batch: ``gen_or_seed`` a sequence of R seeds or generators,
    ``policy`` leaves 0-d, [C] or [R, C], ``stream`` a stacked [R] batch,
    ``events`` per step with [R, C, S] leaves, ``route_draws`` per step
    with the draws' [R, ...] leaves; every output gets a leading [R]
    (``accept`` [R, T, C, A], ``assign`` [R, T, A]), and run r equals the
    fleet run alone on its seed bit for bit.

    Each step: every cluster's dynamics against its own capacity (one
    ``observe_events`` over the cluster axis, each cluster's events from
    its own generator), one candidate-curve evaluation for the step's
    fleet-wide arrivals, the ``router``'s assignment from the per-cluster
    maintained aggregates, then ``decide_batch`` over the cluster axis on
    each cluster's assigned arrivals. The blocked ``agg_refresh_steps``
    refresh recomputes every cluster's aggregate in one aggregate launch.
    Arrivals the router maps to the sentinel ``C`` are counted as
    ``rejected_by_all`` and enter no cluster's admission loop.
    """
    from .routing import LeastUtilizedRouter, RouteContext

    _validate_fleet_config(fcfg)
    cfg = fcfg.base
    core = make_admission_core(cfg, horizon_grid, policy_kind, device=device)
    device = core.device
    n_c = fcfg.n_clusters
    caps = torch.tensor(fcfg.capacities, dtype=F32, device=device)
    router = LeastUtilizedRouter() if router is None else router
    source = PriorArrivalSource() if arrival_source is None else arrival_source
    scfg = stream_config(fcfg)
    k_refresh = cfg.agg_refresh_steps
    n_steps, a_max = cfg.n_steps, cfg.max_arrivals
    arange_a = torch.arange(a_max, device=device)
    arange_c = torch.arange(n_c, device=device)

    def run(gen_or_seed, policy: PolicyParams,
            stream: Optional[ArrivalStream] = None,
            events: Optional[Sequence[StepEvents]] = None,
            route_draws: Optional[Sequence] = None):
        _check_fleet_policy_capacity(policy, fcfg)
        batch = _is_batch(gen_or_seed)
        if batch:
            gens = [_generator(g, device) for g in gen_or_seed]
            runs = len(gens)
        else:
            gens, runs = [_generator(gen_or_seed, device)], None
        lead = (n_c,) if runs is None else (runs, n_c)
        policy = broadcast_policy(tree_to(policy, device), n_c, runs)
        stream = _run_stream(source, scfg, gens, batch, stream, device)
        for name, seq in (("events", events), ("route_draws", route_draws)):
            if seq is not None and len(seq) != n_steps:
                raise ValueError(f"{name} has {len(seq)} steps, the run "
                                 f"{n_steps}")
        fleet = [fleet_generators(g, n_c) for g in gens]
        event_gens = [g for fg in fleet for g in fg[:n_c]]
        route_gen = [fg[n_c] for fg in fleet] if batch else fleet[0][n_c]
        cs = core.init(lead)
        rej_all = torch.zeros(lead[:-1], dtype=F32, device=device)
        util_trace, fail_trace, accepts, assigns = [], [], [], []
        rows = _steps(core.candidate_rows(stream))
        for t, stream_t in enumerate(_steps(stream)):
            if t % k_refresh == 0:
                cs = core.refresh_aggregates(cs)
            ev = (_sample_tables(core, event_gens, cs.slots) if events is None
                  else tree_to(events[t], device))
            cs, out = core.observe_events(cs, ev, caps)

            # 4. route the fleet-wide arrivals, then admit per cluster ------
            valid = arange_a < stream_t.n_arrivals[..., None]
            cand = core.candidates(rows[t])
            ctx = RouteContext(cand=cand, c0=stream_t.c0, valid=valid,
                               agg_el=cs.agg_el, agg_vl=cs.agg_vl,
                               util=out.util, capacities=caps, policy=policy)
            draws = (router.draw(route_gen, ctx) if route_draws is None
                     else tree_to(route_draws[t], device))
            assign = torch.clamp(router.assign(ctx, draws), 0, n_c)
            mask = valid[..., None, :] & (assign[..., None, :]
                                          == arange_c[:, None])   # [C, A]
            rej_all = rej_all + torch.sum((valid & (assign == n_c)).to(F32),
                                          dim=-1)
            cand_c = MomentCurves(*(x[..., None, :, :].expand(
                *x.shape[:-2], n_c, *x.shape[-2:]) for x in cand))
            cs, accept = core.decide_batch(policy, cs, out.util, cand_c,
                                           _to_clusters(stream_t, n_c), mask)
            n_acc = torch.sum(accept.to(F32), dim=-1)
            n_rej = torch.sum(mask.to(F32), dim=-1) - n_acc
            slots, util_end = _accumulate_step(cs.slots, out, n_acc, n_rej,
                                               cfg.dt)
            cs = cs._replace(slots=slots)
            util_trace.append(util_end)
            fail_trace.append(out.failed)
            if record_decisions:
                accepts.append(accept)
                assigns.append(assign)
        metrics = _fleet_metrics(cfg, caps, cs.slots,
                                 torch.stack(util_trace, dim=-1),
                                 torch.stack(fail_trace, dim=-1), rej_all)
        result = (metrics,)
        if record_decisions:
            result += (torch.stack(accepts, dim=-3),
                       torch.stack(assigns, dim=-2))
        if cfg.telemetry:
            result += (cs.tel,)
        return result if len(result) > 1 else metrics

    return run
