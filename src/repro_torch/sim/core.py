"""The admission core: one state + function layer under the simulator.

PyTorch counterpart of ``repro.sim.core`` for one cluster, the GLOBAL prior
mode, no mesh and no telemetry:

  * ``CoreState`` — the slot table with per-deployment conjugate beliefs
    (``SimState``) plus the incrementally-maintained cluster aggregate
    moment curves.
  * ``make_admission_core(cfg, grid, policy_kind, device="cuda")`` — closes
    over the static configuration and returns an ``AdmissionCore`` bundle:

      - ``init()``                         fresh empty state
      - ``refresh_aggregates(cs)``         full aggregate recompute
      - ``sample_events(gen, slots)``      one step's random events
      - ``apply_step_events(slots, ev)``   deaths / scale-out grants /
                                           belief updates from given events
      - ``apply_events(gen, cs)``          the two above, composed
      - ``candidates(stream_t)``           [A, N] candidate moment curves
      - ``decide_batch(policy, cs, …)``    sequential admission + slot
                                           placement + incremental fold

Splitting the step's sampling from its arithmetic lets a test hand the JAX
package's own event draws to the port (the two packages' random bits
differ). Everything runs on the core's ``device`` and in float32; nothing in
a step reads a value back to the host.

One deliberate difference from the JAX package: ``SimConfig`` defaults to the
kernel lanes (``use_kernel=True``, ``agg_backend="kernel"``), because the
card is the target. On CUDA tensors they launch the CUDA kernels, on CPU
tensors they run the kernels' plain PyTorch versions; ``"fused"`` and
``"reference"`` remain selectable as oracle lanes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..core.belief import (GammaBelief, belief_from_prior,
                           observe_initial_size, update_on_events)
from ..core.moments import (MomentCurves, aggregate_moment_curves,
                            moment_curves, moment_curves_fused)
from ..core.policies import (ZEROTH, PolicyParams, admit_sequential,
                             admit_sequential_verbose)
from ..core.processes import (F32, DeploymentParams, PopulationPriors,
                              StepEvents, sample_params, sample_step_events)
from ..device import resolve_device

GLOBAL, PSEUDO, MIX_LABELED, MIX_UNLABELED = "global", "pseudo", "labeled", "unlabeled"
AGG_FUSED, AGG_REFERENCE, AGG_KERNEL = "fused", "reference", "kernel"

# where each option this slice leaves out will be ported
_NOT_PORTED = "is not ported yet: ROADMAP.md, Queue A, {!r}"
_ROADMAP_PRIORS = "Pseudo and mixture priors"
_ROADMAP_TELEMETRY = "Telemetry, mesh and fleet"


class SimConfig(NamedTuple):
    """Static simulation configuration (python values)."""

    capacity: float = 2_000.0
    arrival_rate: float = 0.1        # deployments/hour (paper: 1.0 at c=20,000)
    horizon_hours: float = 365 * 24.0
    dt: float = 6.0                  # hours per step
    max_slots: int = 1024
    max_arrivals: int = 4            # cap per step (Poisson tail clipped)
    prior_mode: str = GLOBAL         # only GLOBAL is ported
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
    telemetry: bool = False          # the telemetry rider is not ported

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


def _check_ported(cfg: SimConfig):
    if cfg.prior_mode != GLOBAL:
        raise NotImplementedError(
            f"prior_mode={cfg.prior_mode!r} "
            + _NOT_PORTED.format(_ROADMAP_PRIORS))
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry=True " + _NOT_PORTED.format(_ROADMAP_TELEMETRY))


def tree_to(tree, device):
    """Move every tensor leaf of a (nested) NamedTuple to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to(x, device) for x in tree))
    return tree


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


class PriorArrivalSource(ArrivalSource):
    """Draw every arrival from the population priors (paper §5 default)."""

    def stream(self, gen: torch.Generator, cfg: SimConfig) -> "ArrivalStream":
        return draw_arrival_stream(gen, cfg)


def draw_arrival_stream(gen: torch.Generator, cfg: SimConfig) -> ArrivalStream:
    """Pre-draw every arrival's true params, request size and prior belief
    (GLOBAL prior mode), on the generator's device."""
    _check_ported(cfg)
    device = gen.device
    t_steps, a_max = cfg.n_steps, cfg.max_arrivals
    shape = (t_steps, a_max)
    rate = torch.full((t_steps,), cfg.arrival_rate * cfg.dt, dtype=F32,
                      device=device)
    n_arr = torch.clamp(torch.poisson(rate, generator=gen),
                        max=a_max).to(torch.int32)
    params = sample_params(gen, cfg.priors, shape, device=device)
    c0 = 1.0 + torch.poisson(params.sig, generator=gen)
    bel = observe_initial_size(belief_from_prior(cfg.priors, shape,
                                                 device=device), c0)
    return ArrivalStream(params=params, c0=c0, bel=bel, bel_alt=bel,
                         n_arrivals=n_arr)


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
    """The complete admission state: slot table + beliefs (``slots``) and the
    incrementally-maintained cluster-wide aggregate moment curves. ``tel``
    mirrors the JAX package's telemetry rider, which is not ported: always
    ``None``."""

    slots: SimState
    agg_el: torch.Tensor          # [N] aggregate E[L_n] over admitted slots
    agg_vl: torch.Tensor          # [N] aggregate V[L_n]
    tel: Optional[object] = None


class StepOutcome(NamedTuple):
    """Per-step dynamics summary (metric inputs)."""

    util: torch.Tensor            # active cores after deaths + grants
    failed: torch.Tensor          # scale-out requests that did not fit
    n_requests: torch.Tensor      # total scale-out requests this step
    departed: torch.Tensor        # deployments that died this step


def _init_state(cfg: SimConfig, device) -> SimState:
    s = cfg.max_slots
    zeros = lambda shape: torch.zeros(shape, dtype=F32, device=device)
    return SimState(
        alive=torch.zeros(s, dtype=torch.bool, device=device),
        cores=zeros(s),
        params=DeploymentParams(lam=zeros(s),
                                mu=torch.ones(s, dtype=F32, device=device),
                                sig=zeros(s)),
        bel=belief_from_prior(cfg.priors, (s,), device=device),
        core_hours=zeros(()), fail_requests=zeros(()),
        total_requests=zeros(()), arr_accepted=zeros(()),
        arr_rejected=zeros(()), slot_overflow=zeros(()), n_departed=zeros(()),
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
    rank = torch.cumsum(free.to(torch.int32), 0)          # free-slot rank, 1-based
    acc = accept.to(torch.int32)
    ordinal = torch.cumsum(acc, 0) * acc                  # i-th accepted, 1-based
    n_free = rank[-1]
    placed_arrival = accept & (ordinal <= n_free)         # [A]
    overflow = state.slot_overflow + torch.sum(
        (accept & ~placed_arrival).to(F32))

    hit = free[None, :] & (rank[None, :] == ordinal[:, None]) & accept[:, None]
    placed = torch.any(hit, dim=0)                        # [S]
    arrivals = torch.arange(accept.shape[0], device=accept.device)
    src = torch.sum(hit.to(torch.int64) * arrivals[:, None], dim=0)  # [S]

    merge = lambda old, new_a: torch.where(placed, new_a[src], old)
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
    on the CPU); AGG_FUSED reduces 512-slot blocks with a left fold, as the
    JAX package's fused path does; AGG_REFERENCE materializes [S, N] and sums
    (the oracle).
    """
    if cfg.agg_backend == AGG_REFERENCE:

        def aggregate(bel, cores, alive):
            curves = moment_curves(bel, cores, grid, cfg.priors,
                                   d_points=cfg.d_points)
            alive_f = alive.to(F32)[:, None]
            return MomentCurves(EL=torch.sum(curves.EL * alive_f, dim=0),
                                VL=torch.sum(curves.VL * alive_f, dim=0))
    elif cfg.agg_backend == AGG_KERNEL:
        from ..kernels.moment_curves.ops import aggregate_moment_curves_kernel

        def aggregate(bel, cores, alive):
            return aggregate_moment_curves_kernel(
                bel, cores, alive, grid, cfg.priors, d_points=cfg.d_points)
    else:

        def aggregate(bel, cores, alive):
            return aggregate_moment_curves(bel, cores, alive, grid,
                                           cfg.priors, d_points=cfg.d_points)

    return aggregate


def _make_curves_fn(cfg: SimConfig):
    """Per-candidate moment-curve evaluator (kernel or packed PyTorch)."""
    if cfg.use_kernel:
        from ..kernels.moment_curves.ops import moment_curves_kernel

        return moment_curves_kernel
    return moment_curves_fused


def _make_candidates_fn(cfg: SimConfig, grid: torch.Tensor,
                        needs_moments: bool, n_grid: int, curves_fn):
    """[A, N] candidate curves for one step's pre-drawn arrivals (zeros when
    the policy ignores them)."""

    def candidates(stream_t: ArrivalStream) -> MomentCurves:
        if not needs_moments:
            zeros = torch.zeros((stream_t.c0.shape[0], n_grid), dtype=F32,
                                device=stream_t.c0.device)
            return MomentCurves(EL=zeros, VL=zeros)
        return curves_fn(stream_t.bel, stream_t.c0, grid, cfg.priors,
                         d_points=cfg.d_points)

    return candidates


def _sample_events(cfg: SimConfig, gen: torch.Generator,
                   slots: SimState) -> StepEvents:
    """One step's random events for the slot table (dead slots get zero
    rates)."""
    return sample_step_events(gen, slots.params, slots.cores, cfg.priors,
                              cfg.dt, alive=slots.alive)


def _apply_step_events(cfg: SimConfig, slots: SimState, ev: StepEvents,
                       capacity):
    """Steps 1–3 of one ``dt``-hour step from given events: deaths,
    scale-out grants against ``capacity`` in slot order, and conjugate
    belief updates. Returns (slots, StepOutcome); the metric accumulators
    are untouched (the caller folds them after admission)."""
    alive_f = slots.alive.to(F32)

    # 1. deaths ---------------------------------------------------------
    deaths = torch.minimum(ev.core_deaths.to(F32), slots.cores) * alive_f
    exposure = slots.cores * cfg.dt * alive_f
    cores = slots.cores - deaths
    cores = torch.where(ev.spont_death & slots.alive, 0.0, cores)
    alive = slots.alive & (cores > 0.0)
    departed = torch.sum((slots.alive & ~alive).to(F32))
    alive_f = alive.to(F32)

    # 2. scale-outs (only deployments still alive request) ---------------
    req = ev.scaleout_cores.to(F32) * alive_f
    n_req = ev.n_scaleouts.to(F32) * alive_f
    util = torch.sum(cores * alive_f)
    grant = (util + torch.cumsum(req, 0)) <= capacity
    cores = cores + torch.where(grant, req, 0.0)
    failed = torch.sum(torch.where(grant, 0.0, n_req))
    util = torch.sum(cores * alive_f)

    # 3. belief updates (requests are observed whether or not granted) ---
    bel = update_on_events(
        slots.bel, core_deaths=deaths, exposure_core_hours=exposure,
        n_scaleouts=n_req, scaleout_cores=req, alive_hours=cfg.dt * alive_f,
        priors=cfg.priors)
    slots = slots._replace(alive=alive, cores=cores, bel=bel)
    return slots, StepOutcome(util=util, failed=failed,
                              n_requests=torch.sum(n_req), departed=departed)


class AdmissionCore(NamedTuple):
    """Bundle of functions over ``CoreState`` for one static configuration
    (see the module docstring). Built by ``make_admission_core``."""

    cfg: SimConfig
    grid: torch.Tensor
    policy_kind: int
    needs_moments: bool
    n_grid: int
    device: torch.device
    init: Callable[[], CoreState]
    refresh_aggregates: Callable[[CoreState], CoreState]
    sample_events: Callable[..., StepEvents]
    apply_step_events: Callable[..., tuple]
    apply_events: Callable[..., tuple]
    candidates: Callable[[ArrivalStream], MomentCurves]
    decide_batch: Callable[..., tuple]
    decide_batch_traced: Callable[..., tuple]


def make_admission_core(cfg: SimConfig, grid, policy_kind: int, *,
                        device="cuda", mesh=None) -> AdmissionCore:
    """Build the admission-core function bundle for one configuration, on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    _validate_config(cfg)
    _check_ported(cfg)
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh " + _NOT_PORTED.format(_ROADMAP_TELEMETRY))
    device = resolve_device(device)
    if not isinstance(grid, torch.Tensor):
        grid = torch.tensor(grid, dtype=F32)
    grid = grid.to(device=device, dtype=F32)
    needs_moments = policy_kind != ZEROTH
    n_grid = grid.shape[0] if needs_moments else 1
    aggregate_fn = _make_aggregate_fn(cfg, grid)
    candidates_fn = _make_candidates_fn(cfg, grid, needs_moments, n_grid,
                                        _make_curves_fn(cfg))

    def zeros_grid():
        return torch.zeros((n_grid,), dtype=F32, device=device)

    def init() -> CoreState:
        return CoreState(slots=_init_state(cfg, device), agg_el=zeros_grid(),
                         agg_vl=zeros_grid())

    def refresh_aggregates(cs: CoreState) -> CoreState:
        """Full aggregate recompute from the slot table (block boundary).
        Zeroth-moment policies never read the curves, so their refresh
        keeps the zero placeholder instead of paying for the reduction."""
        if not needs_moments:
            return cs._replace(agg_el=zeros_grid(), agg_vl=zeros_grid())
        agg = aggregate_fn(cs.slots.bel, cs.slots.cores, cs.slots.alive)
        return cs._replace(agg_el=agg.EL, agg_vl=agg.VL)

    def sample_events(gen: torch.Generator, slots: SimState) -> StepEvents:
        return _sample_events(cfg, gen, slots)

    def apply_step_events(slots: SimState, events: StepEvents,
                          capacity=None):
        cap = cfg.capacity if capacity is None else capacity
        return _apply_step_events(cfg, slots, events, cap)

    def apply_events(gen: torch.Generator, cs: CoreState, capacity=None):
        """One ``dt``-hour step of cluster dynamics with freshly sampled
        events. The maintained aggregate is NOT touched — within-block
        staleness is the ``agg_refresh_steps`` contract."""
        slots, out = apply_step_events(cs.slots,
                                       sample_events(gen, cs.slots), capacity)
        return cs._replace(slots=slots), out

    def _decide_core(policy: PolicyParams, cs: CoreState, util,
                     cand: MomentCurves, stream_t: ArrivalStream, valid,
                     verbose: bool):
        if verbose:
            res, diag = admit_sequential_verbose(
                policy, cs.agg_el, cs.agg_vl, util, cand, stream_t.c0, valid)
        else:
            res = admit_sequential(policy, cs.agg_el, cs.agg_vl, util, cand,
                                   stream_t.c0, valid)
            diag = None
        slots, placed_arrival = _place_arrivals(cs.slots, res.accept,
                                                stream_t)
        placed_f = placed_arrival.to(F32)
        agg_el = cs.agg_el + torch.einsum("an,a->n", cand.EL, placed_f)
        agg_vl = cs.agg_vl + torch.einsum("an,a->n", cand.VL, placed_f)
        return CoreState(slots=slots, agg_el=agg_el,
                         agg_vl=agg_vl), res.accept, diag

    def decide_batch(policy: PolicyParams, cs: CoreState, util,
                     cand: MomentCurves, stream_t: ArrivalStream, valid):
        """Greedy first-come-first-served admission of a candidate batch
        against the maintained aggregate (paper Assumption 3), slot
        placement, and the incremental aggregate fold of *placed* arrivals.
        Returns (cs, accept [A])."""
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

    return AdmissionCore(
        cfg=cfg, grid=grid, policy_kind=policy_kind,
        needs_moments=needs_moments, n_grid=n_grid, device=device, init=init,
        refresh_aggregates=refresh_aggregates, sample_events=sample_events,
        apply_step_events=apply_step_events, apply_events=apply_events,
        candidates=candidates_fn, decide_batch=decide_batch,
        decide_batch_traced=decide_batch_traced)
