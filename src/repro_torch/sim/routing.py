"""Fleet routing: assign each arriving deployment to a cluster (paper §2).

The paper frames the provider's problem as dispatch-then-admit: a workload
first goes to one of many clusters, and that cluster's admission policy then
accepts or rejects it. ``make_fleet_run`` calls a ``Router`` once per step,
*before* ``core.policies.admit_sequential`` runs inside the target cluster —
so a router chooses where an arrival is considered, and the per-cluster
policy still has the final word.

A router maps the step's ``[A]`` arrivals to cluster indices in ``[0, C)``
— or to the sentinel ``C`` ("no cluster would take it"), which the fleet
simulator counts as **rejected-by-all** without entering any cluster's
admission scan. Routers see the ``RouteContext``: the candidates' moment
curves, each cluster's maintained aggregate curves and instantaneous
utilization, the per-cluster capacities, and the fleet policy ([C]
leaves).

PyTorch counterpart of ``repro.sim.routing``. Each router separates its
random draws (``draw(gen, ctx)``, from a ``torch.Generator``) from its
arithmetic (``assign(ctx, draws)``), as the admission core separates
``sample_events`` from ``observe_events``: a test can then hand the port
the JAX package's draws. ``route`` is the two in turn. The sequential
routers loop over the A arrivals in Python with tensor ops only, reading
nothing back to the host; ``torch.argmin``/``torch.argmax`` take the
first index on ties, as ``jnp`` does. Load fractions multiply by the
capacities' reciprocal: XLA compiles the JAX package's division by its
constant capacity vector so, the two differ by an ulp, and fractions tie
often (integer cores over round capacities), where an ulp picks the
cluster.

Runs: every ``RouteContext`` leaf may carry a leading run axis (R fleet
runs: ``c0`` [R, A], ``agg_el`` [R, C, N], ``util`` [R, C], policy leaves
[R, C] or [C]; ``capacities`` stays [C]); each run is routed on its own.

Shipped routers:

  * ``RandomRouter``          — uniform over clusters (the null baseline).
  * ``LeastUtilizedRouter``   — lowest utilization *fraction*, folding each
    routed arrival's request into the running utilization so a burst within
    one step spreads instead of dogpiling.
  * ``PowerOfTwoRouter``      — power-of-two-choices (two distinct
    clusters), scored on the per-cluster aggregate moment curves
    (predicted peak load fraction ``max_n agg_EL / capacity``); falls back
    to instantaneous utilization when the curves are all zero (zeroth).
  * ``ThresholdCascadeRouter``— try clusters in index order and take the
    first whose admission condition (``core.policies.decide`` on the
    running aggregates) would accept; arrivals no cluster would accept get
    the rejected-by-all sentinel. Routed candidates are folded into the
    chosen cluster's running aggregates with ``admit_sequential``'s fold
    (the same ops in the same order), so every routed arrival is admitted
    by its target cluster, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.moments import MomentCurves
from ..core.policies import PolicyParams, decide


class RouteContext(NamedTuple):
    """Everything a router may consult for one step's assignment."""

    cand: MomentCurves       # [A, N] candidate moment curves
    c0: torch.Tensor         # [A] requested initial cores
    valid: torch.Tensor      # [A] bool: slot actually carries an arrival
    agg_el: torch.Tensor     # [C, N] per-cluster maintained aggregate E[L]
    agg_vl: torch.Tensor     # [C, N] per-cluster maintained aggregate V[L]
    util: torch.Tensor       # [C] instantaneous active cores per cluster
    capacities: torch.Tensor  # [C] per-cluster core capacities
    policy: PolicyParams     # cluster-axis-broadcast fleet policy ([C] fields)

    @property
    def n_clusters(self) -> int:
        return self.capacities.shape[0]


def _randint(gen: torch.Generator, high: int, shape) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         dtype=torch.int64, device=gen.device)


class Router:
    """Pluggable arrival→cluster assignment. Subclasses implement
    ``assign`` (and ``draw`` when they are random).

    ``assign(ctx, draws)`` returns an ``[A]`` int64 tensor of cluster
    indices in ``[0, C]`` — the value ``C`` is the rejected-by-all
    sentinel; entries for invalid arrival slots are ignored. ``draw(gen,
    ctx)`` makes the router's random draws for one step (None for a
    deterministic router); ``gen`` is a ``torch.Generator``, or a sequence
    of R of them for a context of R runs (run r's draws from ``gen[r]``, as
    a call on that run alone draws them).
    """

    name: str = "?"

    def draw(self, gen, ctx: RouteContext):
        return None

    def assign(self, ctx: RouteContext, draws) -> torch.Tensor:
        raise NotImplementedError

    def route(self, gen, ctx: RouteContext) -> torch.Tensor:
        return self.assign(ctx, self.draw(gen, ctx))


def _per_run(gen, fn):
    """``fn(g)`` for one generator, stacked over a sequence of them."""
    if isinstance(gen, torch.Generator):
        return fn(gen)
    outs = [fn(g) for g in gen]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


class RandomRouter(Router):
    """Uniform random assignment — the null baseline every other router must
    beat at matched fleet SLA. Draws: one index an arrival."""

    name = "random"

    def draw(self, gen, ctx: RouteContext) -> torch.Tensor:
        a = ctx.c0.shape[-1]
        return _per_run(gen, lambda g: _randint(g, ctx.n_clusters, (a,)))

    def assign(self, ctx: RouteContext, draws) -> torch.Tensor:
        return torch.as_tensor(draws, device=ctx.c0.device).to(torch.int64)


class LeastUtilizedRouter(Router):
    """Send each arrival to the cluster with the lowest utilization fraction.

    Arrivals within one step are assigned sequentially, folding each routed
    request's ``c0`` into the running utilization, so a same-step burst
    spreads across clusters instead of all chasing the same pre-step argmin.
    """

    name = "least_utilized"

    def assign(self, ctx: RouteContext, draws=None) -> torch.Tensor:
        idx = torch.arange(ctx.n_clusters, device=ctx.util.device)
        inv = 1.0 / ctx.capacities
        u = ctx.util
        out = []
        for i in range(ctx.c0.shape[-1]):
            c = torch.argmin(u * inv, dim=-1)
            ok = ctx.valid[..., i]
            u = u + torch.where((idx == c[..., None]) & ok[..., None],
                                ctx.c0[..., i, None], 0.0)
            out.append(c)
        return torch.stack(out, dim=-1)


class PowerOfTwoRouter(Router):
    """Power-of-two-choices over the per-cluster aggregate moment curves.

    Each arrival samples two *distinct* clusters (the second uniform over
    the rest) and takes the one whose predicted peak load fraction —
    ``max_n agg_EL[c, n] / capacity_c``, the aggregate the admission
    policies consume — is lower. With a zeroth-moment policy the curves are
    all zero, so the score falls back to the instantaneous utilization
    fraction. Draws: (first choice in [0, C), offset in [0, max(C-1, 1)))
    an arrival.
    """

    name = "power_of_two"

    def draw(self, gen, ctx: RouteContext):
        a, n_c = ctx.c0.shape[-1], ctx.n_clusters
        return _per_run(gen, lambda g: (_randint(g, n_c, (a,)),
                                        _randint(g, max(n_c - 1, 1), (a,))))

    def assign(self, ctx: RouteContext, draws) -> torch.Tensor:
        n_c = ctx.n_clusters
        first, off = (torch.as_tensor(x, device=ctx.c0.device).to(
            torch.int64) for x in draws)
        second = (first + 1 + off) % n_c
        inv = 1.0 / ctx.capacities
        curve_score = torch.amax(ctx.agg_el, dim=-1) * inv
        util_score = ctx.util * inv
        has_curves = torch.amax(ctx.agg_el.flatten(-2), dim=-1) > 0.0
        score = torch.where(has_curves[..., None], curve_score, util_score)
        pick = lambda c: torch.gather(score, -1, c)
        return torch.where(pick(first) <= pick(second), first, second)


class ThresholdCascadeRouter(Router):
    """First cluster (in index order) whose admission policy would accept,
    with routed candidates folded into the running per-cluster aggregates.

    Arrivals are considered sequentially within the step; an arrival is
    routed to the lowest-index cluster whose ``core.policies.decide``
    accepts it on that cluster's *running* (agg_EL, agg_VL, util) state,
    and its curves and request are folded into the chosen cluster before
    the next arrival is scored, with ``admit_sequential``'s own ops. By
    induction every cascade-routed arrival is then accepted by its target
    cluster's sequential admission (same ``decide``, same running state).
    Arrivals no cluster accepts get the rejected-by-all sentinel ``C``. The
    target cluster's ``admit_sequential`` remains authoritative — the fold
    here is a per-step shadow of it, never written back.
    """

    name = "cascade"

    def assign(self, ctx: RouteContext, draws=None) -> torch.Tensor:
        n_c = ctx.n_clusters
        idx = torch.arange(n_c, device=ctx.util.device)
        el, vl, u = ctx.agg_el, ctx.agg_vl, ctx.util
        out = []
        for i in range(ctx.c0.shape[-1]):
            ce = ctx.cand.EL[..., None, i, :]          # [..., 1, N]
            cv = ctx.cand.VL[..., None, i, :]
            c0 = ctx.c0[..., i, None]                  # [..., 1]
            acc = decide(ctx.policy, el, vl, u, MomentCurves(ce, cv), c0)
            routed = torch.any(acc, dim=-1) & ctx.valid[..., i]
            c = torch.argmax(acc.to(torch.uint8), dim=-1)
            sel = (idx == c[..., None]) & routed[..., None]   # [..., C]
            el = torch.where(sel[..., None], el + ce, el)
            vl = torch.where(sel[..., None], vl + cv, vl)
            u = torch.where(sel, u + c0, u)
            out.append(torch.where(routed, c, n_c))
        return torch.stack(out, dim=-1)


#: name -> router class (a zero-argument factory), for benchmarks and CLIs
ROUTERS = {
    r.name: r for r in (RandomRouter, LeastUtilizedRouter, PowerOfTwoRouter,
                        ThresholdCascadeRouter)
}

