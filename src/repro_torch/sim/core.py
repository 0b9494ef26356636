"""The admission core: one state + function layer under the simulator.

PyTorch counterpart of ``repro.sim.core``: one cluster or a fleet, every
prior mode (GLOBAL, §6 PSEUDO, §7 MIX_LABELED and MIX_UNLABELED), with the
telemetry rider, and one cluster's slot table sharded over a device mesh
(``slot_mesh``, ``make_admission_core(..., mesh=)``):

  * ``CoreState`` — the slot table with per-deployment conjugate beliefs
    (``SimState``) plus the incrementally-maintained cluster aggregate
    moment curves.
  * ``make_admission_core(cfg, grid, policy_kind, device="cuda")`` — closes
    over the static configuration and returns an ``AdmissionCore`` bundle:

      - ``init(runs=None)``                fresh empty state (of ``runs``
                                           runs: a leading run axis)
      - ``refresh_aggregates(cs)``         full aggregate recompute
      - ``sample_events(gen, slots)``      one step's random events
      - ``observe_events(cs, ev)``         deaths / scale-out grants /
                                           belief updates (and the rider's
                                           window fold) from given events
      - ``apply_events(gen, cs)``          sampling, then ``observe_events``
      - ``candidate_rows(stream)``         the rows the candidates' curves
                                           read (a run's, once)
      - ``candidates(rows_t)``             [A, N] candidate moment curves
      - ``decide_batch(policy, cs, …)``    sequential admission + slot
                                           placement + incremental fold
      - ``gather_slots(slots)``            the whole slot table on the
                                           core's device (the table itself
                                           unless it is sharded)
      - ``util(slots)``                    active cores of the table

With ``SimConfig(telemetry=True)`` the state carries the
``obs.counters.TelemetryState`` rider: ``refresh_aggregates`` marks the
refresh, ``observe_events`` folds the window, ``decide_batch`` the
decisions (through ``admit_sequential_fits``, whose decisions are
``admit_sequential``'s). Off, ``CoreState.tel`` is ``None`` and nothing of
it runs.

Splitting the step's sampling from its arithmetic lets a test hand the JAX
package's own event draws to the port (the two packages' random bits
differ). Everything runs on the core's ``device`` and in float32; nothing in
a step reads a value back to the host.

Runs: every function takes the state of one run (slot leaves [S], the
aggregate [N]) or of R runs at once (a leading run axis: [R, S], [R, N],
arrivals [R, A]), where the JAX package vmaps. A fleet (``FleetConfig``,
``sim.simulator.make_fleet_run``) adds a cluster axis the same way: [C, S]
slot leaves, or [R, C, S] for R fleet runs, with a [C] capacity vector
for ``observe_events``; the refresh sums every table of the state in one
aggregate launch. Each run of a batch gets the
bits it gets alone: every reduction inside a run is over integer counts
(exact in any order), the aggregate kernel sums each run in the one-run
order, the candidates' curves are per row, and placed candidates are folded
into the aggregate one at a time in arrival order (the admit loop's running
aggregate, capped at the free slots). Each run's events come
from its own generator (``sample_events(gens, slots)``).

One deliberate difference from the JAX package: ``SimConfig`` defaults to the
kernel lanes (``use_kernel=True``, ``agg_backend="kernel"``), because the
card is the target. On CUDA tensors they launch the CUDA kernels, on CPU
tensors they run the kernels' plain PyTorch versions; ``"fused"`` and
``"reference"`` remain selectable as oracle lanes.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..core.belief import (GammaBelief, apply_pseudo_observations,
                           belief_from_prior, observe_initial_size,
                           update_on_events)
from ..core.moments import (MomentCurves, aggregate_moment_curves,
                            masked_curve_reduction, moment_curves,
                            moment_curves_fused)
from ..core.policies import (ZEROTH, PolicyParams, admit_sequential,
                             admit_sequential_fits, admit_sequential_verbose)
from ..core.pricing import mixture_moments
from ..core.processes import (F32, DeploymentParams, PopulationPriors,
                              StepEvents, sample_initial_size, sample_params,
                              sample_pseudo_observations, sample_step_events)
from ..device import (Mesh, canonical_device, resolve_device,
                      visible_devices)
from ..obs.counters import (TelemetryState, WindowStats, fold_decisions,
                            fold_window, init_telemetry, mark_refresh)
from ..obs.tracing import annotate

GLOBAL, PSEUDO, MIX_LABELED, MIX_UNLABELED = "global", "pseudo", "labeled", "unlabeled"
AGG_FUSED, AGG_REFERENCE, AGG_KERNEL = "fused", "reference", "kernel"

# the two components' weights of an unlabeled (§7) arrival
_MIX_WEIGHTS = (0.5, 0.5)


class SimConfig(NamedTuple):
    """Static simulation configuration (python values)."""

    capacity: float = 2_000.0
    arrival_rate: float = 0.1        # deployments/hour (paper: 1.0 at c=20,000)
    horizon_hours: float = 365 * 24.0
    dt: float = 6.0                  # hours per step
    max_slots: int = 1024
    max_arrivals: int = 4            # cap per step (Poisson tail clipped)
    prior_mode: str = GLOBAL         # GLOBAL | PSEUDO | MIX_LABELED | MIX_UNLABELED
    n_pseudo_obs: int = 0            # paper §6: 0/1/5/50
    d_points: int = 24               # D-term checkpoint count
    use_kernel: bool = True          # per-candidate curves through the
                                     # moment-curve kernel (CUDA on the card)
    agg_backend: str = AGG_KERNEL    # AGG_KERNEL | AGG_FUSED | AGG_REFERENCE:
                                     # how the cluster-wide aggregate curves
                                     # are recomputed at each refresh
    agg_refresh_steps: int = 1       # full aggregate recompute every K steps;
                                     # between refreshes placed candidates'
                                     # curves are folded in incrementally
    priors: PopulationPriors = None  # population priors; prefer make_config,
                                     # which defaults these to AZURE_PRIORS
    telemetry: bool = False          # carry the obs.counters.TelemetryState
                                     # rider in CoreState.tel

    @property
    def n_steps(self) -> int:
        return int(round(self.horizon_hours / self.dt))


def make_config(**overrides) -> SimConfig:
    """Documented SimConfig constructor: ``priors`` defaults to the fitted
    Azure priors instead of ``None`` and every field is validated eagerly."""
    if overrides.get("priors") is None:
        from ..core.processes import AZURE_PRIORS

        overrides["priors"] = AZURE_PRIORS
    return _validate_config(SimConfig(**overrides))


def _validate_config(cfg: SimConfig) -> SimConfig:
    if cfg.priors is None:
        raise ValueError(
            "SimConfig.priors is None. Construct configs via "
            "repro_torch.sim.make_config(...) (defaults to AZURE_PRIORS) or "
            "pass priors=<PopulationPriors> explicitly."
        )
    if cfg.prior_mode not in (GLOBAL, PSEUDO, MIX_LABELED, MIX_UNLABELED):
        raise ValueError(f"unknown prior_mode {cfg.prior_mode!r}")
    if cfg.agg_backend not in (AGG_FUSED, AGG_REFERENCE, AGG_KERNEL):
        raise ValueError(f"unknown agg_backend {cfg.agg_backend!r}")
    if cfg.n_pseudo_obs < 0:
        raise ValueError(f"n_pseudo_obs={cfg.n_pseudo_obs} must be >= 0")
    if cfg.prior_mode != GLOBAL and cfg.n_pseudo_obs == 0:
        raise ValueError(
            f"prior_mode={cfg.prior_mode!r} with n_pseudo_obs=0 silently "
            "degenerates to GLOBAL (zero pseudo observations leave every "
            "belief — including the §7 mixture components — at the "
            "population prior): use prior_mode=GLOBAL, or set "
            "n_pseudo_obs >= 1"
        )
    if cfg.n_steps <= 0 or cfg.max_slots <= 0 or cfg.max_arrivals <= 0:
        raise ValueError(
            f"degenerate SimConfig: n_steps={cfg.n_steps} "
            f"max_slots={cfg.max_slots} max_arrivals={cfg.max_arrivals}"
        )
    if cfg.agg_refresh_steps < 1 or cfg.n_steps % cfg.agg_refresh_steps:
        raise ValueError(
            f"agg_refresh_steps={cfg.agg_refresh_steps} must be >= 1 and "
            f"divide n_steps={cfg.n_steps}"
        )
    return cfg


def tree_to(tree, device):
    """Move every tensor leaf of a (nested) NamedTuple to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(x, device) for x in tree))
    return tree


class FleetConfig(NamedTuple):
    """Static fleet configuration: a per-cluster ``SimConfig`` template plus
    the per-cluster capacities.

    ``base`` describes each cluster's slot array, step size, information
    model, and aggregate-refresh blocking — *and* the fleet-wide arrival
    process (``arrival_rate``/``max_arrivals`` are the whole fleet's: one
    stream is drawn and routed, not one per cluster). ``base.capacity``
    conventionally holds the fleet total (``make_fleet_config`` sets it);
    the authoritative per-cluster capacities are ``capacities``.
    """

    base: SimConfig
    capacities: tuple                # per-cluster core capacities (static)

    @property
    def n_clusters(self) -> int:
        return len(self.capacities)

    @property
    def total_capacity(self) -> float:
        return float(sum(self.capacities))


def make_fleet_config(capacities, **base_overrides) -> FleetConfig:
    """Documented FleetConfig constructor: ``base_overrides`` build the
    per-cluster template through ``make_config`` (priors default to
    AZURE_PRIORS, every field validated); ``base.capacity`` defaults to the
    fleet total."""
    caps = tuple(float(c) for c in capacities)
    base_overrides.setdefault("capacity", sum(caps))
    return _validate_fleet_config(
        FleetConfig(base=make_config(**base_overrides), capacities=caps))


def _validate_fleet_config(fcfg: FleetConfig) -> FleetConfig:
    if not fcfg.capacities:
        raise ValueError("FleetConfig.capacities is empty")
    if any(not math.isfinite(c) or c <= 0.0 for c in fcfg.capacities):
        raise ValueError(
            f"FleetConfig.capacities must be positive, got {fcfg.capacities}")
    _validate_config(fcfg.base)
    return fcfg


def stream_config(cfg) -> SimConfig:
    """The ``SimConfig`` governing arrival-stream layout and priors:
    identity for a ``SimConfig``; for a ``FleetConfig`` the base template
    with the fleet-total capacity (fleet arrivals are drawn fleet-wide and
    only routed to clusters at simulation time)."""
    if isinstance(cfg, FleetConfig):
        return cfg.base._replace(capacity=cfg.total_capacity)
    return cfg


class ArrivalStream(NamedTuple):
    """Pre-drawn per-(step, arrival-slot) quantities. Leading dims [T, A]."""

    params: DeploymentParams         # true parameters of the arriving deployment
    c0: torch.Tensor                 # initial request size
    bel: GammaBelief                 # provider's prior belief for the arrival
    bel_alt: GammaBelief             # second mixture component (unlabeled mode)
    n_arrivals: torch.Tensor         # [T] int32 arrivals per step (capped)


class ArrivalSource:
    """Pluggable producer of the pre-drawn ``ArrivalStream``: ``make_run``
    consumes arrivals only through this interface."""

    def stream(self, gen: torch.Generator, cfg: SimConfig) -> "ArrivalStream":
        raise NotImplementedError

    def shares_stream(self, cfg: SimConfig) -> bool:
        """True when ``stream`` draws nothing from its generator, so that a
        batch may build it once for every run."""
        return False


class PriorArrivalSource(ArrivalSource):
    """Draw every arrival from the population priors (paper §5 default)."""

    def stream(self, gen: torch.Generator, cfg: SimConfig) -> "ArrivalStream":
        return draw_arrival_stream(gen, cfg)


def draw_arrival_stream(gen: torch.Generator, cfg: SimConfig) -> ArrivalStream:
    """Pre-draw every arrival's true params, request size and prior belief,
    on the generator's device.

    GLOBAL: the population prior. PSEUDO (§6): the prior with
    ``n_pseudo_obs`` pseudo observations of the arrival's own processes.
    MIX_LABELED / MIX_UNLABELED (§7): the user has two types, the submitted
    deployment (``params``) and an independent draw; the provider holds
    ``n_pseudo_obs`` observations of each, ``bel`` and ``bel_alt``.
    ``bel`` then sees the request size C0; ``bel_alt`` does not, as in the
    JAX package (outside the mixture modes it is ``bel`` before C0). The
    GLOBAL draws come first, in the same order in every mode."""
    device = gen.device
    t_steps, a_max = cfg.n_steps, cfg.max_arrivals
    shape = (t_steps, a_max)
    rate = torch.full((t_steps,), cfg.arrival_rate * cfg.dt, dtype=F32,
                      device=device)
    n_arr = torch.clamp(torch.poisson(rate, generator=gen),
                        max=a_max).to(torch.int32)
    params = sample_params(gen, cfg.priors, shape, device=device)
    c0 = sample_initial_size(gen, params)
    prior = belief_from_prior(cfg.priors, shape, device=device)
    observed = lambda p: apply_pseudo_observations(
        prior, sample_pseudo_observations(gen, p, cfg.priors,
                                          cfg.n_pseudo_obs), cfg.priors)
    if cfg.prior_mode == GLOBAL:
        bel = bel_alt = prior
    elif cfg.prior_mode == PSEUDO:
        bel = bel_alt = observed(params)
    else:
        alt = sample_params(gen, cfg.priors, shape, device=device)
        bel = observed(params)
        bel_alt = observed(alt)
    bel = observe_initial_size(bel, c0)
    return ArrivalStream(params=params, c0=c0, bel=bel, bel_alt=bel_alt,
                         n_arrivals=n_arr)


class CandidateRows(NamedTuple):
    """What the candidates' curves read: the arrivals' beliefs and request
    sizes, leaves [..., A]. In the §7 unlabeled mode each leaf holds both
    type components side by side, [..., 2, A] (``bel``, then ``bel_alt``),
    so that one call of the row evaluator takes both."""

    bel: GammaBelief
    c0: torch.Tensor


def candidate_rows(cfg: SimConfig, stream: ArrivalStream) -> CandidateRows:
    """The candidates' rows of a stream of any leading shape: [T, (R,) A]
    leaves for a run's stream (built once a run; a step's rows are then
    views), [(R,) A] for one step's. Outside the unlabeled mode these are
    the stream's own leaves."""
    if cfg.prior_mode != MIX_UNLABELED:
        return CandidateRows(bel=stream.bel, c0=stream.c0)
    pair = lambda x, y: torch.stack([x, y], dim=-2)
    return CandidateRows(bel=GammaBelief(*map(pair, stream.bel,
                                              stream.bel_alt)),
                         c0=pair(stream.c0, stream.c0))


def row_curves(cfg: SimConfig, grid: torch.Tensor, rows: CandidateRows,
               curves_fn) -> MomentCurves:
    """Every row's curves from one call of ``curves_fn``: [..., N] for
    leaves [...]. Rows are independent, so a row's bits do not depend on
    the rows beside it."""
    shape = tuple(rows.c0.shape)
    flat = lambda x: x.reshape(-1)
    curves = curves_fn(GammaBelief(*map(flat, rows.bel)), flat(rows.c0),
                       grid, cfg.priors, d_points=cfg.d_points)
    return MomentCurves(*(x.reshape(*shape, -1) for x in curves))


def type_curves(cfg: SimConfig, grid: torch.Tensor, rows: CandidateRows,
                curves_fn) -> MomentCurves:
    """The unlabeled mode's per-type curves of ``candidate_rows``' rows:
    [2, ..., A, N], type first, from one call for both types."""
    return MomentCurves(*(x.movedim(-3, 0) for x in
                          row_curves(cfg, grid, rows, curves_fn)))


class SimState(NamedTuple):
    """Slot table (fixed-capacity deployment array + conjugate beliefs) plus
    the run-level metric accumulators (0-d float32 tensors)."""

    alive: torch.Tensor           # [S] bool
    cores: torch.Tensor           # [S] float32
    params: DeploymentParams      # [S]
    bel: GammaBelief              # [S]
    core_hours: torch.Tensor
    fail_requests: torch.Tensor
    total_requests: torch.Tensor
    arr_accepted: torch.Tensor
    arr_rejected: torch.Tensor
    slot_overflow: torch.Tensor
    n_departed: torch.Tensor


class CoreState(NamedTuple):
    """The complete admission state: slot table + beliefs (``slots``), the
    incrementally-maintained cluster-wide aggregate moment curves, and the
    telemetry rider ``tel`` (an ``obs.counters.TelemetryState`` with
    ``SimConfig(telemetry=True)``, else ``None``)."""

    slots: SimState
    agg_el: torch.Tensor          # [N] ([R, N]) aggregate E[L_n] over
                                  # admitted slots
    agg_vl: torch.Tensor          # [N] ([R, N]) aggregate V[L_n]
    tel: Optional[TelemetryState] = None


class StepOutcome(NamedTuple):
    """Per-step dynamics summary (metric inputs)."""

    util: torch.Tensor            # active cores after deaths + grants
    failed: torch.Tensor          # scale-out requests that did not fit
    n_requests: torch.Tensor      # total scale-out requests this step
    departed: torch.Tensor        # deployments that died this step


def lead_shape(runs) -> tuple:
    """The leading axes of a state of ``runs``: none for one run, (R,) for
    R runs, or a tuple of them as it is (e.g. (R, C) for R fleet runs)."""
    if runs is None:
        return ()
    return tuple(runs) if isinstance(runs, tuple) else (int(runs),)


def _init_state(cfg: SimConfig, device, runs=None) -> SimState:
    lead = lead_shape(runs)
    s = (*lead, cfg.max_slots)
    zeros = lambda shape: torch.zeros(shape, dtype=F32, device=device)
    return SimState(
        alive=torch.zeros(s, dtype=torch.bool, device=device),
        cores=zeros(s),
        params=DeploymentParams(lam=zeros(s),
                                mu=torch.ones(s, dtype=F32, device=device),
                                sig=zeros(s)),
        bel=belief_from_prior(cfg.priors, s, device=device),
        core_hours=zeros(lead), fail_requests=zeros(lead),
        total_requests=zeros(lead), arr_accepted=zeros(lead),
        arr_rejected=zeros(lead), slot_overflow=zeros(lead),
        n_departed=zeros(lead),
    )


def _place_arrivals(state: SimState, accept: torch.Tensor,
                    stream_t: ArrivalStream):
    """Place accepted arrivals into free slots, one vectorized pass.

    The i-th accepted arrival goes to the i-th free slot (in slot order);
    accepted arrivals beyond the number of free slots are counted as slot
    overflow. Returns (state, placed_arrival [A]): the accepted arrivals
    that landed in a slot, the only ones the caller folds into the
    maintained aggregate.
    """
    alive = state.alive
    free = ~alive
    rank = torch.cumsum(free.to(torch.int32), -1)         # free-slot rank, 1-based
    acc = accept.to(torch.int32)
    ordinal = torch.cumsum(acc, -1) * acc                 # i-th accepted, 1-based
    n_free = rank[..., -1:]
    placed_arrival = accept & (ordinal <= n_free)         # [A]
    overflow = state.slot_overflow + torch.sum(
        (accept & ~placed_arrival).to(F32), dim=-1)

    hit = (free[..., None, :] & (rank[..., None, :] == ordinal[..., :, None])
           & accept[..., :, None])                        # [A, S]
    placed = torch.any(hit, dim=-2)                       # [S]
    arrivals = torch.arange(accept.shape[-1], device=accept.device)
    src = torch.sum(hit.to(torch.int64) * arrivals[:, None], dim=-2)  # [S]

    merge = lambda old, new_a: torch.where(
        placed, torch.gather(new_a, -1, src), old)
    state = state._replace(
        alive=alive | placed,
        cores=merge(state.cores, stream_t.c0),
        params=DeploymentParams(*map(merge, state.params, stream_t.params)),
        bel=GammaBelief(*map(merge, state.bel, stream_t.bel)),
        slot_overflow=overflow)
    return state, placed_arrival


def _make_aggregate_fn(cfg: SimConfig, grid: torch.Tensor):
    """Cluster-wide sum-over-alive-slots curve evaluator, by backend.

    AGG_KERNEL is the aggregate kernel (CUDA on the card, its plain version
    on the CPU; R runs' tables in one launch); AGG_FUSED reduces 512-slot
    blocks with a left fold, as the JAX package's fused path does;
    AGG_REFERENCE materializes [S, N] and sums (the oracle). The two oracle
    lanes take R runs' tables one run at a time. Tables with more than one
    leading axis ([R, C, S] of a fleet batch) are summed as one [R C, S]
    batch.
    """
    if cfg.agg_backend == AGG_KERNEL:
        from ..kernels.moment_curves.ops import aggregate_moment_curves_kernel

        def tables(bel, cores, alive):
            return aggregate_moment_curves_kernel(
                bel, cores, alive, grid, cfg.priors, d_points=cfg.d_points)

        return _over_tables(tables)
    if cfg.agg_backend == AGG_REFERENCE:

        def one_run(bel, cores, alive):
            curves = moment_curves(bel, cores, grid, cfg.priors,
                                   d_points=cfg.d_points)
            alive_f = alive.to(F32)[:, None]
            return MomentCurves(EL=torch.sum(curves.EL * alive_f, dim=0),
                                VL=torch.sum(curves.VL * alive_f, dim=0))
    else:

        def one_run(bel, cores, alive):
            return aggregate_moment_curves(bel, cores, alive, grid,
                                           cfg.priors, d_points=cfg.d_points)

    def tables(bel, cores, alive):
        if cores.ndim == 1:
            return one_run(bel, cores, alive)
        runs = [one_run(GammaBelief(*(x[r] for x in bel)), cores[r],
                        alive[r]) for r in range(cores.shape[0])]
        return MomentCurves(*(torch.stack(x) for x in zip(*runs)))

    return _over_tables(tables)


def _over_tables(tables):
    """``tables`` (slot columns [S] or [R, S]) taking columns with any
    number of leading axes: more than one is flattened into one [R C, S]
    batch (a view of the contiguous state) and the sums are shaped back."""
    def aggregate(bel, cores, alive):
        lead = cores.shape[:-1]
        if len(lead) <= 1:
            return tables(bel, cores, alive)
        flat = lambda x: x.reshape(-1, x.shape[-1])
        out = tables(GammaBelief(*map(flat, bel)), flat(cores), flat(alive))
        return MomentCurves(*(x.reshape(*lead, -1) for x in out))

    return aggregate


def _make_curves_fn(cfg: SimConfig):
    """Per-candidate moment-curve evaluator (kernel or packed PyTorch)."""
    if cfg.use_kernel:
        from ..kernels.moment_curves.ops import moment_curves_kernel

        return moment_curves_kernel
    return moment_curves_fused


def _make_candidates_fn(cfg: SimConfig, grid: torch.Tensor,
                        needs_moments: bool, n_grid: int, curves_fn):
    """[A, N] candidate curves for one step's ``CandidateRows`` ([R, A, N]
    for R runs': their R A rows in one call), zeros when the policy ignores
    them. In the §7 unlabeled mode a candidate is the mixture of its two
    type components, whose 2 R A rows go through one call."""
    mixture = cfg.prior_mode == MIX_UNLABELED
    weights = torch.tensor(_MIX_WEIGHTS, dtype=F32, device=grid.device)

    def candidates(rows_t: CandidateRows) -> MomentCurves:
        with annotate("repro.sim.candidates"):
            if not needs_moments:
                shape = rows_t.c0.shape
                if mixture:     # [..., 2, A] rows: [..., A] candidates
                    shape = (*shape[:-2], shape[-1])
                zeros = torch.zeros((*shape, n_grid), dtype=F32,
                                    device=rows_t.c0.device)
                return MomentCurves(EL=zeros, VL=zeros)
            if mixture:
                return mixture_moments(weights, type_curves(
                    cfg, grid, rows_t, curves_fn))
            return row_curves(cfg, grid, rows_t, curves_fn)

    return candidates


def _sample_events(cfg: SimConfig, gen, slots: SimState) -> StepEvents:
    """One step's random events for the slot table (dead slots get zero
    rates); ``gen`` is a generator, or one for each run of [R, S] slots."""
    with annotate("repro.sim.draws"):
        return sample_step_events(gen, slots.params, slots.cores, cfg.priors,
                                  cfg.dt, alive=slots.alive)


def _apply_step_events(cfg: SimConfig, slots: SimState, ev: StepEvents,
                       capacity, with_stats: bool = False):
    """Steps 1–3 of one ``dt``-hour step from given events: deaths,
    scale-out grants against ``capacity`` in slot order, and conjugate
    belief updates. Returns (slots, StepOutcome, stats); the metric
    accumulators are untouched (the caller folds them after admission).
    ``stats`` is the window's ``WindowStats`` when ``with_stats`` (the
    telemetry rider's input), else ``None``."""
    alive_f = slots.alive.to(F32)

    # 1. deaths ---------------------------------------------------------
    deaths = torch.minimum(ev.core_deaths.to(F32), slots.cores) * alive_f
    exposure = slots.cores * cfg.dt * alive_f
    cores = slots.cores - deaths
    cores = torch.where(ev.spont_death & slots.alive, 0.0, cores)
    alive = slots.alive & (cores > 0.0)
    departed = torch.sum((slots.alive & ~alive).to(F32), dim=-1)
    alive_f = alive.to(F32)

    # 2. scale-outs (only deployments still alive request) ---------------
    req = ev.scaleout_cores.to(F32) * alive_f
    n_req = ev.n_scaleouts.to(F32) * alive_f
    util = torch.sum(cores * alive_f, dim=-1)
    if isinstance(capacity, torch.Tensor):     # [C] or [R, C]: per table
        capacity = capacity[..., None]
    grant = (util[..., None] + torch.cumsum(req, -1)) <= capacity
    cores = cores + torch.where(grant, req, 0.0)
    failed = torch.sum(torch.where(grant, 0.0, n_req), dim=-1)
    util = torch.sum(cores * alive_f, dim=-1)

    # 3. belief updates (requests are observed whether or not granted) ---
    bel = update_on_events(
        slots.bel, core_deaths=deaths, exposure_core_hours=exposure,
        n_scaleouts=n_req, scaleout_cores=req, alive_hours=cfg.dt * alive_f,
        priors=cfg.priors)
    n_requests = torch.sum(n_req, dim=-1)
    stats = None
    if with_stats:
        total = lambda x: torch.sum(x, dim=-1)
        stats = WindowStats(
            core_deaths=total(deaths), exposure_core_hours=total(exposure),
            n_scaleouts=n_requests, scaleout_cores=total(req),
            alive_hours=cfg.dt * total(alive_f),
            spont_deaths=total((ev.spont_death & slots.alive).to(F32)),
            departed=departed)
    slots = slots._replace(alive=alive, cores=cores, bel=bel)
    return slots, StepOutcome(util=util, failed=failed,
                              n_requests=n_requests,
                              departed=departed), stats


def _slot_util(slots: SimState) -> torch.Tensor:
    """Active cores of a slot table ([S] leaves, or [..., S])."""
    return torch.sum(slots.cores * slots.alive.to(F32), dim=-1)


class AdmissionCore(NamedTuple):
    """Bundle of functions over ``CoreState`` for one static configuration
    (see the module docstring). Built by ``make_admission_core``; ``mesh``
    is the ``device.Mesh`` its slot table is sharded over, or ``None``."""

    cfg: SimConfig
    grid: torch.Tensor
    policy_kind: int
    needs_moments: bool
    n_grid: int
    device: torch.device
    init: Callable[..., CoreState]
    refresh_aggregates: Callable[[CoreState], CoreState]
    sample_events: Callable[..., StepEvents]
    observe_events: Callable[..., tuple]
    apply_events: Callable[..., tuple]
    candidate_rows: Callable[[ArrivalStream], CandidateRows]
    candidates: Callable[[CandidateRows], MomentCurves]
    decide_batch: Callable[..., tuple]
    decide_batch_traced: Callable[..., tuple]
    gather_slots: Callable[[SimState], SimState]
    util: Callable[[SimState], torch.Tensor]
    mesh: Optional[Mesh] = None


def slot_mesh(n_shards: int, devices=None, *, device="cuda") -> Mesh:
    """A 1-d device mesh named ``"slots"`` over the first ``n_shards`` of
    ``devices`` (default: ``device.visible_devices`` of ``device``'s kind,
    the card unless the caller passes ``"cpu"``): the mesh
    ``make_admission_core(..., mesh=...)`` shards the slot table over.
    Raises when there are too few devices, naming the variable that asks
    for logical ones."""
    if devices is None:
        devices = visible_devices(device)
    devices = [canonical_device(d) for d in devices]
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if n_shards > len(devices):
        raise ValueError(
            f"n_shards={n_shards} exceeds the {len(devices)} visible "
            f"device(s); export REPRO_TORCH_DEVICE_COUNT={n_shards} for "
            "that many logical devices on the ones there are")
    return Mesh(tuple(devices[:n_shards]), ("slots",))


def make_admission_core(cfg: SimConfig, grid, policy_kind: int, *,
                        device="cuda", mesh=None) -> AdmissionCore:
    """Build the admission-core function bundle for one configuration, on
    ``device`` (the card unless the caller passes ``"cpu"``).

    ``mesh`` (a 1-d ``device.Mesh``, see ``slot_mesh``) selects the sharded
    lane: the slot table is split over the mesh's devices and the core runs
    on its first device (``device`` is then not read); decisions,
    aggregates, metrics and the rider stay bit for bit the unsharded
    core's (``_shard_over_slots``)."""
    _validate_config(cfg)
    device = (canonical_device(mesh.devices[0]) if mesh is not None
              else resolve_device(device))
    if not isinstance(grid, torch.Tensor):
        grid = torch.tensor(grid, dtype=F32)
    grid = grid.to(device=device, dtype=F32)
    needs_moments = policy_kind != ZEROTH
    n_grid = grid.shape[0] if needs_moments else 1
    aggregate_fn = _make_aggregate_fn(cfg, grid)
    candidates_fn = _make_candidates_fn(cfg, grid, needs_moments, n_grid,
                                        _make_curves_fn(cfg))

    def init(runs=None) -> CoreState:
        """A fresh empty state: of one run, of ``runs`` runs, or with the
        leading axes of a tuple ``runs`` ((C,) for a fleet, (R, C) for R
        fleet runs)."""
        lead = lead_shape(runs)
        zeros = lambda: torch.zeros((*lead, n_grid), dtype=F32,
                                    device=device)
        tel = init_telemetry(runs, device) if cfg.telemetry else None
        return CoreState(slots=_init_state(cfg, device, runs), agg_el=zeros(),
                         agg_vl=zeros(), tel=tel)

    def refresh_aggregates(cs: CoreState) -> CoreState:
        """Full aggregate recompute from the slot table (block boundary).
        Zeroth-moment policies never read the curves, so their refresh
        keeps the zero placeholder instead of paying for the reduction.
        With telemetry the rider's staleness clock returns to zero."""
        with annotate("repro.sim.refresh"):
            tel = mark_refresh(cs.tel) if cfg.telemetry else cs.tel
            if not needs_moments:
                return cs._replace(agg_el=torch.zeros_like(cs.agg_el),
                                   agg_vl=torch.zeros_like(cs.agg_vl),
                                   tel=tel)
            agg = aggregate_fn(cs.slots.bel, cs.slots.cores, cs.slots.alive)
            return cs._replace(agg_el=agg.EL, agg_vl=agg.VL, tel=tel)

    def sample_events(gen, slots: SimState) -> StepEvents:
        return _sample_events(cfg, gen, slots)

    def observe_events(cs: CoreState, events: StepEvents, capacity=None):
        """One ``dt``-hour step of cluster dynamics from given (observed or
        pre-drawn) events, scale-outs granted against ``capacity`` (the
        config's by default; a fleet passes its [C] capacities); with
        telemetry the rider folds the window's occupancy and observable
        sufficient statistics. The maintained
        aggregate is NOT touched — within-block staleness is the
        ``agg_refresh_steps`` contract."""
        cap = cfg.capacity if capacity is None else capacity
        with annotate("repro.sim.events"):
            slots, out, stats = _apply_step_events(
                cfg, cs.slots, events, cap, with_stats=cfg.telemetry)
            tel = (fold_window(cs.tel, out.util, cap, stats) if cfg.telemetry
                   else cs.tel)
        return cs._replace(slots=slots, tel=tel), out

    def apply_events(gen, cs: CoreState, capacity=None):
        """``observe_events`` on freshly sampled events."""
        return observe_events(cs, sample_events(gen, cs.slots), capacity)

    def _decide_core(policy: PolicyParams, cs: CoreState, util,
                     cand: MomentCurves, stream_t: ArrivalStream, valid,
                     verbose: bool):
        # the placed candidates' fold is the admit loop's running aggregate
        # capped at the free slots: added one at a time in arrival order,
        # the same for a run alone and in a batch
        with annotate("repro.sim.decide"):
            room = (torch.sum(~cs.slots.alive, dim=-1) if needs_moments
                    else None)
            args = (policy, cs.agg_el, cs.agg_vl, util, cand, stream_t.c0,
                    valid)
            diag = fits = None
            if verbose:
                res, diag = admit_sequential_verbose(*args, room=room)
                fits = diag.fits
            elif cfg.telemetry:     # the rider needs the fit flags, not scores
                res, fits = admit_sequential_fits(*args, room=room)
            else:
                res = admit_sequential(*args, room=room)
        with annotate("repro.sim.place"):
            slots, placed = _place_arrivals(cs.slots, res.accept, stream_t)
            tel = (fold_decisions(cs.tel, res.accept, valid, fits, placed,
                                  stream_t.c0) if cfg.telemetry else cs.tel)
        agg_el, agg_vl = ((res.agg_el, res.agg_vl) if needs_moments
                          else (cs.agg_el, cs.agg_vl))
        return CoreState(slots=slots, agg_el=agg_el, agg_vl=agg_vl,
                         tel=tel), res.accept, diag

    def decide_batch(policy: PolicyParams, cs: CoreState, util,
                     cand: MomentCurves, stream_t: ArrivalStream, valid):
        """Greedy first-come-first-served admission of a candidate batch
        against the maintained aggregate (paper Assumption 3), slot
        placement, and the incremental aggregate fold of *placed* arrivals.
        Returns (cs, accept [A]). With telemetry the rider folds the
        batch's reason counters and the admitted-arrival stream moments."""
        cs, accept, _ = _decide_core(policy, cs, util, cand, stream_t, valid,
                                     verbose=False)
        return cs, accept

    def decide_batch_traced(policy: PolicyParams, cs: CoreState, util,
                            cand: MomentCurves, stream_t: ArrivalStream,
                            valid):
        """``decide_batch`` + the per-candidate ``DecisionDiag`` (``[A]``:
        fit flag, policy score, bound). Returns (cs, accept, diag)."""
        return _decide_core(policy, cs, util, cand, stream_t, valid,
                            verbose=True)

    core = AdmissionCore(
        cfg=cfg, grid=grid, policy_kind=policy_kind,
        needs_moments=needs_moments, n_grid=n_grid, device=device, init=init,
        refresh_aggregates=refresh_aggregates, sample_events=sample_events,
        observe_events=observe_events, apply_events=apply_events,
        candidate_rows=lambda stream: candidate_rows(cfg, stream),
        candidates=candidates_fn, decide_batch=decide_batch,
        decide_batch_traced=decide_batch_traced,
        gather_slots=lambda slots: slots, util=_slot_util)
    return core if mesh is None else _shard_over_slots(core, mesh)


class Shards(tuple):
    """One [S] leaf of a sharded slot table: its shards' tensors in mesh
    order, each on its shard's device and none a view of another."""


def _slot_leaves(slots: SimState) -> list:
    """The [S] leaves of a slot table, in a fixed order."""
    return [slots.alive, slots.cores, *slots.params, *slots.bel]


def _with_slot_leaves(slots: SimState, leaves) -> SimState:
    n_p = len(DeploymentParams._fields)
    return slots._replace(alive=leaves[0], cores=leaves[1],
                          params=DeploymentParams(*leaves[2:2 + n_p]),
                          bel=GammaBelief(*leaves[2 + n_p:]))


def _shard_over_slots(core: AdmissionCore, mesh: Mesh) -> AdmissionCore:
    """Wrap an ``AdmissionCore`` so that the slot table is sharded over
    ``mesh`` (one axis), keeping decisions, aggregates, metrics and the
    rider **bit for bit** the unsharded core's. The counterpart of the JAX
    package's ``shard_map`` lane, in one process:

      * Every [S] leaf of ``SimState`` is a ``Shards``: ``S / n`` slots a
        device, each shard a tensor of its own (on logical devices of one
        card too). The scalar accumulators, the aggregate curves, the rider,
        the policy and the arrivals are replicated: held once, on the
        mesh's first device, where the replicated work runs.
      * ``refresh_aggregates`` evaluates each shard's per-slot curves on
        its own device, gathers the [S, N] curves on the first device and
        reduces them with ``masked_curve_reduction``, the unsharded fused
        lane's block order (a left fold of 512-slot blocks). A row's curves
        have the same bits whatever rows are evaluated beside it
        (``core.moments._curves_from_packed``), and per-shard partial sums
        added across shards would not be the same sum: gathering the curves
        and reducing them in the canonical order is what keeps it exact.
      * The step's dynamics and admission (``sample_events``,
        ``observe_events``, ``apply_events``, ``decide_batch[_traced]``)
        run once, on the first device, on the gathered table, and their
        [S] results are sliced back to the shards (a leaf a step leaves
        alone keeps its shards). The events are drawn once from the
        caller's generator on the gathered table, as the unsharded core
        draws them.
    """
    cfg = core.cfg
    if len(mesh.axis_names) != 1:
        raise ValueError(f"mesh must have exactly one axis, got "
                         f"{mesh.axis_names}")
    devices = tuple(canonical_device(d) for d in mesh.devices)
    n_shards = len(devices)
    if cfg.max_slots % n_shards:
        raise ValueError(
            f"max_slots={cfg.max_slots} must be divisible by the "
            f"{n_shards}-device mesh")
    if cfg.agg_backend != AGG_FUSED:
        raise ValueError(
            f"sharded admission core requires agg_backend={AGG_FUSED!r} "
            f"(got {cfg.agg_backend!r}): the sharded refresh mirrors the "
            "fused block reduction bit-for-bit")
    s_local = cfg.max_slots // n_shards
    first = core.device
    grids = [core.grid.to(d) for d in devices]

    def gather(leaf: Shards) -> torch.Tensor:
        return torch.cat([x.to(first) for x in leaf])

    def scatter(x: torch.Tensor) -> Shards:
        return Shards(x[i * s_local:(i + 1) * s_local].to(d, copy=True)
                      for i, d in enumerate(devices))

    def gather_slots(slots: SimState) -> SimState:
        return _with_slot_leaves(slots, [gather(x)
                                         for x in _slot_leaves(slots)])

    def rescatter(new: SimState, full: SimState, old: SimState) -> SimState:
        return _with_slot_leaves(new, [
            o if x is f else scatter(x) for x, f, o in
            zip(_slot_leaves(new), _slot_leaves(full), _slot_leaves(old))])

    def init(runs=None) -> CoreState:
        if runs is not None:
            raise ValueError("a sharded core holds one run's slot table")
        cs = core.init()
        return cs._replace(slots=_with_slot_leaves(
            cs.slots, [scatter(x) for x in _slot_leaves(cs.slots)]))

    def refresh_aggregates(cs: CoreState) -> CoreState:
        if not core.needs_moments:
            return core.refresh_aggregates(cs)
        with annotate("repro.sim.refresh"):
            tel = mark_refresh(cs.tel) if cfg.telemetry else cs.tel
            bel = cs.slots.bel
            parts = [moment_curves_fused(GammaBelief(*(x[i] for x in bel)),
                                         cs.slots.cores[i], grids[i],
                                         cfg.priors, d_points=cfg.d_points)
                     for i in range(n_shards)]
            curves = MomentCurves(*(torch.cat([x.to(first) for x in xs])
                                    for xs in zip(*parts)))
            agg = masked_curve_reduction(curves,
                                         gather(cs.slots.alive).to(F32))
            return cs._replace(agg_el=agg.EL, agg_vl=agg.VL, tel=tel)

    def on_gathered(cs: CoreState, step):
        """``step(full_cs) -> (cs, *rest)`` on the gathered table, its [S]
        results sliced back to the shards."""
        full = gather_slots(cs.slots)
        new, *rest = step(cs._replace(slots=full))
        return (new._replace(slots=rescatter(new.slots, full, cs.slots)),
                *rest)

    def observe_events(cs: CoreState, events: StepEvents, capacity=None):
        return on_gathered(cs, lambda c: core.observe_events(c, events,
                                                             capacity))

    def apply_events(gen, cs: CoreState, capacity=None):
        return on_gathered(cs, lambda c: core.observe_events(
            c, core.sample_events(gen, c.slots), capacity))

    def decide_batch(policy: PolicyParams, cs: CoreState, *args):
        return on_gathered(cs, lambda c: core.decide_batch(policy, c, *args))

    def decide_batch_traced(policy: PolicyParams, cs: CoreState, *args):
        return on_gathered(cs, lambda c: core.decide_batch_traced(
            policy, c, *args))

    return core._replace(
        init=init, refresh_aggregates=refresh_aggregates,
        sample_events=lambda gen, slots: core.sample_events(
            gen, gather_slots(slots)),
        observe_events=observe_events, apply_events=apply_events,
        decide_batch=decide_batch, decide_batch_traced=decide_batch_traced,
        gather_slots=gather_slots,
        util=lambda slots: _slot_util(slots._replace(
            alive=gather(slots.alive), cores=gather(slots.cores))),
        mesh=Mesh(devices, tuple(mesh.axis_names)))
