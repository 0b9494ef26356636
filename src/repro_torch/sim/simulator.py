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
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.policies import PolicyParams
from ..core.processes import F32, StepEvents
from .core import (ArrivalSource, ArrivalStream, PriorArrivalSource,
                   SimConfig, SimState, StepOutcome, make_admission_core,
                   tree_to)

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


def _run_metrics(cfg: SimConfig, slots: SimState, util_trace,
                 fail_trace) -> RunMetrics:
    """Assemble ``RunMetrics`` from the final slot-table accumulators."""
    return RunMetrics(
        utilization=slots.core_hours / (cfg.horizon_hours * cfg.capacity),
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
    ``record_decisions=True``.

    A batch: ``gen_or_seed`` a sequence of R seeds or generators (or a 1-d
    array of seeds), ``policy`` leaves 0-d (shared) or [R], ``stream`` a
    stacked batch with a leading [R] (leaves [R, T, A], as the JAX package
    stacks them), ``events`` per step with [R, S] leaves. The batch's
    metrics have a leading [R] (``accept`` is [R, T, A]), and run r equals
    the run alone on its seed bit for bit.

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
        if stream is not None:
            stream = tree_to(stream, device)
            if batch:   # [R, T, ...] -> [T, R, ...]: a step's slice is [R, A]
                stream = _tree_map(lambda x: x.movedim(0, 1).contiguous(),
                                   stream)
        elif batch:
            stream = _tree_map(lambda *xs: torch.stack(xs, dim=1),
                               *(source.stream(g, cfg) for g in gen))
        else:
            stream = source.stream(gen, cfg)
        if events is not None and len(events) != n_steps:
            raise ValueError(f"events has {len(events)} steps, the run "
                             f"{n_steps}")
        cs = core.init(runs)
        util_trace, fail_trace, accepts = [], [], []
        for t, stream_t in enumerate(_steps(stream)):
            if t % k_refresh == 0:
                cs = core.refresh_aggregates(cs)
            if events is None:
                cs, out = core.apply_events(gen, cs)
            else:
                slots, out = core.apply_step_events(
                    cs.slots, tree_to(events[t], device))
                cs = cs._replace(slots=slots)

            # 4. arrivals, admitted against the maintained aggregate ------
            valid = arange_a < stream_t.n_arrivals[..., None]
            cand = core.candidates(stream_t)
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
        if record_decisions:
            return metrics, torch.stack(accepts, dim=-2)
        return metrics

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
