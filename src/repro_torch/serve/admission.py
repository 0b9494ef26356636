"""Online admission service: the simulator's admission core, served live.

PyTorch counterpart of the JAX package's ``serve/admission.py`` for one
cluster or a routed fleet, on one device. The paper's provider "has to continuously decide"
admission as workloads arrive; this module is that decision loop as a
long-lived engine rather than ``make_run``'s offline loop:

  * ``OnlineAdmissionEngine`` holds one ``CoreState`` (slot table, beliefs,
    the maintained aggregate moment curves, the optional telemetry rider) on
    its device and advances it with the same ``sim.core.make_admission_core``
    functions ``make_run`` steps. Because the functions are shared, feeding
    the engine ``make_run``'s generator and arrival stream reproduces its
    decisions and final metrics bit for bit
    (``tests/test_torch_admission.py``). Where the JAX engine donates the
    state through jitted steps, the port rebinds it: each step makes new
    tensors for the leaves it changes, as ``make_run`` does, and nothing
    copies the slot table.
  * A **micro-batching front-end**: concurrent ``submit()`` calls enqueue
    arrival tickets (numpy on the host, no device work on the caller's
    thread) and receive futures; each ``flush()`` coalesces the queue into
    fixed-width decision batches, one row-kernel launch and one host sync
    a batch (``naive=True`` is the ablation: one aggregate recompute and a
    width-1 decision a request).
  * **Event ingestion between decisions**: ``tick()`` advances the cluster
    one ``dt``-hour window, with events drawn from the fitted processes by
    a ``torch.Generator`` (``tick(gen=...)``, the benchmark/daemon regime,
    in ``make_run``'s order of draws) or observed (``tick(events=...)``,
    the production regime), and refreshes the aggregate on the blocked
    ``agg_refresh_steps`` schedule (from the measured K-curve when a scale
    name is given).
  * **Threads**: ``start()`` runs a pump or a deadline-aware flush scheduler
    on a background thread. Every method that touches the state runs on
    the engine's device and on the CUDA stream current when the engine was
    built, whatever thread calls it, under one state lock.

Fleet configurations (``FleetConfig``) run the same engine with a [C]
cluster axis and a ``sim.routing.Router`` assigning each micro-batch lane
to a cluster before per-cluster admission, as ``make_fleet_run`` steps
them: ``tick(gen=...)`` draws each cluster's events from its own generator
(``sim.simulator.fleet_generators``), and a micro-batch's curves are
evaluated once for every cluster.

Left out, each raising ``NotImplementedError`` that names its ROADMAP
Queue A item: ``shards=`` (item 5, the mesh), ``drift_detector=`` (item 8).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import threading
import time
import warnings
from concurrent.futures import Future
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.belief import GammaBelief, belief_from_prior, observe_initial_size
from ..core.policies import PolicyParams
from ..core.processes import (F32, DeploymentParams, StepEvents,
                              sample_initial_size, sample_params)
from ..device import resolve_device
from ..obs.counters import TelemetryState, telemetry_summary
from ..obs.export import HostHistogram, log_buckets
from ..obs.tracing import DecisionTracer, annotate
from ..core.moments import MomentCurves
from ..sim.core import (ArrivalStream, CoreState, FleetConfig, SimConfig,
                        StepOutcome, make_admission_core, tree_to)
from ..sim.routing import RouteContext
from ..sim.simulator import (_accumulate_step, _check_fleet_policy_capacity,
                             _fleet_metrics,
                             _run_metrics, _sample_tables, _to_clusters,
                             broadcast_policy, fleet_generators)

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))

_NOT_PORTED = "is not ported yet: ROADMAP.md, Queue A, item {}"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One admission request: the per-arrival lane of an ``ArrivalStream``,
    as numpy float32 scalars on the host.

    ``params`` are the arrival's true process parameters, used only to
    *simulate* the deployment's future dynamics (benchmarks, the daemon's
    synthetic load); a production deployment's real events arrive through
    ``tick(events=...)`` instead.
    """

    c0: float
    bel: GammaBelief               # the provider's prior belief
    bel_alt: GammaBelief           # second mixture component (§7 unlabeled)
    params: DeploymentParams

    @staticmethod
    def from_stream(stream: ArrivalStream, t: int, a: int) -> "Arrival":
        """Lane ``a`` of step ``t`` of a stream with [T, A] leaves (tensors
        or numpy arrays)."""
        pick = lambda x: _host(x[t, a])
        return Arrival(c0=float(pick(stream.c0)),
                       bel=GammaBelief(*map(pick, stream.bel)),
                       bel_alt=GammaBelief(*map(pick, stream.bel_alt)),
                       params=DeploymentParams(*map(pick, stream.params)))

    @staticmethod
    def draw(gen: torch.Generator, cfg: SimConfig) -> "Arrival":
        """Sample one arrival from the population priors (ad-hoc load),
        with ``gen`` on any device."""
        params = sample_params(gen, cfg.priors, ())
        c0 = sample_initial_size(gen, params)
        bel = GammaBelief(*map(_host, observe_initial_size(
            belief_from_prior(cfg.priors, (), device=gen.device), c0)))
        return Arrival(c0=float(c0), bel=bel, bel_alt=bel,
                       params=DeploymentParams(*map(_host, params)))


class ExternalEvents(NamedTuple):
    """Observed cluster events for one ``dt``-hour window (production
    ingestion path — replaces the fitted processes' simulated draw).

    All arrays are per slot, ``[S]`` (``[C, S]`` for fleets):
    ``core_deaths`` cores lost per deployment, ``spont_death`` whole-deployment shutdowns, and the
    window's scale-out demand (``scaleout_cores`` cores over
    ``n_scaleouts`` requests; grants are decided against capacity in slot
    order, exactly as the simulated path does).
    """

    core_deaths: np.ndarray
    spont_death: np.ndarray
    scaleout_cores: np.ndarray
    n_scaleouts: np.ndarray


def window_seed(seed: int, tick: int) -> int:
    """The seed of the events path's window ``tick`` of an engine seeded
    ``seed``: a ``numpy.random.SeedSequence`` word of (seed, tick), so that
    engines with different seeds do not correlate and a restart repeats
    its chain (the JAX engine's ``fold_in(PRNGKey(seed), tick)``)."""
    word = np.random.SeedSequence([int(seed), int(tick)]).generate_state(
        1, np.uint64)[0]
    return int(word >> np.uint64(1))


class OnlineAdmissionEngine:
    """Long-lived micro-batched admission engine over one ``AdmissionCore``.

    Protocol (one ``dt``-hour window per ``tick``, decisions in between)::

        eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy)
        fut = eng.submit(Arrival.draw(gen, cfg))   # any thread, any time
        eng.tick(gen=gen)                          # dynamics + agg refresh
        eng.flush()                                # decide pending batch
        fut.result()                               # -> bool (admitted?)
        ...
        eng.metrics()                              # RunMetrics so far

    ``cfg`` is a single cluster's ``SimConfig`` or a ``FleetConfig`` (a
    [C] cluster axis, each micro-batch routed by ``router``, default
    ``LeastUtilizedRouter``, then admitted per cluster; ``metrics()`` then
    returns ``FleetMetrics``); the state lives on ``device`` (the card
    unless the caller passes ``"cpu"``).
    ``naive=True`` selects the ablation front-end: one full aggregate
    recompute and a width-1 decision per request (what admission costs
    without the maintained incremental aggregate).

    Latency and key knobs:

      * ``flush_slo_ms=L`` replaces caller-driven flushing with the
        deadline scheduler (see ``start``/``_deadline_loop``): partial
        micro-batches fire when the oldest pending request approaches its
        L-millisecond decision SLO, full batches when ``micro_batch``
        requests are queued. Misses are counted in
        ``metrics_snapshot()["engine"]["deadline_misses"]``.
      * ``seed`` roots the engine's seed chain: the observed-events tick
        path derives its window seed with ``window_seed(seed, tick)``.

    Observability: with ``cfg.telemetry`` the ``CoreState`` carries the
    telemetry rider through every step, and ``metrics_snapshot()`` exports
    it (plus host-side decision-latency / flush-batch-size histograms and
    queue/pump gauges) without synchronizing the pump — that is what the
    daemon's ``/metrics`` endpoint serves. An attached
    ``obs.tracing.DecisionTracer`` receives one structured record per
    ``submit``-path decision, with the policy score from the traced decide
    path.
    """

    def __init__(self, cfg, grid, policy_kind: int, policy: PolicyParams, *,
                 router=None, micro_batch: Optional[int] = None,
                 naive: bool = False, scale: Optional[str] = None,
                 tracer: Optional[DecisionTracer] = None,
                 drift_detector=None, shards: Optional[int] = None,
                 flush_slo_ms: Optional[float] = None, seed: int = 0,
                 device="cuda"):
        self.fleet = isinstance(cfg, FleetConfig)
        if not (self.fleet or isinstance(cfg, SimConfig)):
            raise TypeError(f"cfg must be a SimConfig or a FleetConfig, got "
                            f"{type(cfg).__name__}")
        if router is not None and not self.fleet:
            raise ValueError("router= routes a fleet's arrivals: pass a "
                             "FleetConfig")
        if shards is not None and int(shards) != 1:
            raise NotImplementedError("shards= " + _NOT_PORTED.format(
                "5 (mesh)"))
        if drift_detector is not None:
            raise NotImplementedError(
                "drift_detector= " + _NOT_PORTED.format(
                    "8 (tuning/drift.py)"))
        base = cfg.base if self.fleet else cfg
        if scale is not None:
            from ..tuning.kcurve import pick_agg_refresh

            base = base._replace(agg_refresh_steps=pick_agg_refresh(
                scale, fallback=base.agg_refresh_steps,
                n_steps=base.n_steps))
        self.cfg = (FleetConfig(base=base, capacities=cfg.capacities)
                    if self.fleet else base)
        self.base = base
        self.n_shards = 1
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.core = make_admission_core(base, grid, policy_kind,
                                        device=self.device)
        # the stream every thread's work goes to (None on the CPU)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.k_refresh = base.agg_refresh_steps
        if flush_slo_ms is not None and flush_slo_ms <= 0:
            raise ValueError("flush_slo_ms must be positive")
        self.flush_slo_s = (None if flush_slo_ms is None
                            else float(flush_slo_ms) / 1e3)
        self.deadline_misses = 0
        self._flush_cost_s = 0.0    # EWMA of observed flush wall time
        self.seed = int(seed)
        self.naive = naive
        self.width = int(micro_batch or base.max_arrivals)
        self.n_c = self.cfg.n_clusters if self.fleet else 1
        self.policy = tree_to(policy, self.device)
        self._caps = self.router = None
        if self.fleet:
            from ..sim.routing import LeastUtilizedRouter

            _check_fleet_policy_capacity(policy, self.cfg)
            self._caps = torch.tensor(self.cfg.capacities, dtype=F32,
                                      device=self.device)
            self.router = LeastUtilizedRouter() if router is None else router
            self.policy = broadcast_policy(self.policy, self.n_c)

        # -- engine state ---------------------------------------------------
        with self._on_device():
            self._cs: CoreState = self.core.init(
                (self.n_c,) if self.fleet else None)
            # window accept/reject counts ([C] on the device for a fleet),
            # and a fleet's arrivals routed nowhere
            self._acc, self._rej = self._zero_counts(), self._zero_counts()
            self._rej_all = self._zero_counts(())
        self._out: Optional[StepOutcome] = None   # current window's dynamics
        self._util = None                         # decision-time utilization
        self._window_seed: Optional[int] = None   # events path's window seed
        self._gens = None        # fleet: (tick generator, its C + 1 derived)
        self._route_gen = None   # fleet: the open window's router generator
        self.ticks = 0
        self.decisions = 0
        self._util_trace: list = []
        self._fail_trace: list = []
        self._pad = self._pad_lane()

        # -- micro-batch front-end ------------------------------------------
        self._pending: list = []                  # [(Arrival, Future, t_sub)]
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._pump: Optional[threading.Thread] = None
        self._stop = threading.Event()

        # -- observability --------------------------------------------------
        # one reentrant lock serializes every step and rebinding of the
        # state against metrics_snapshot's clone of the rider; it is taken
        # before _lock wherever both are held
        self._state_lock = threading.RLock()
        self.tracer = tracer
        if self.flush_slo_s is not None:
            # SLO-anchored buckets: the SLO itself is a bucket edge, so the
            # interpolated p99 certifies SLO attainment (p99 <= SLO exactly
            # when no observation crossed the SLO edge)
            slo = self.flush_slo_s
            self._hist_latency = HostHistogram(
                log_buckets(slo / 512.0, slo, 10) + (2.0 * slo, 4.0 * slo))
        else:
            self._hist_latency = HostHistogram()  # submit->decision, seconds
        self._hist_batch = HostHistogram(
            log_buckets(1.0, float(max(self.width, 2)), 8))
        self.n_flushes = 0
        self.n_refreshes = 0
        self._pump_idle_s = 0.0
        self._pump_busy_s = 0.0
        self._req_id = 0
        self._last_diag = None                    # DecisionDiag of last slice
        self._policy_info = {
            "kind": _host(policy.kind).tolist(),
            "threshold": _host(policy.threshold).tolist(),
            "rho": _host(policy.rho).tolist(),
        }

    def _zero_counts(self, shape=None):
        """A window's zero counts: a number for one cluster; for a fleet a
        float32 tensor on the device (of ``shape``, [C] by default), so
        that counting a slice copies nothing to the device."""
        if not self.fleet:
            return 0.0
        shape = (self.n_c,) if shape is None else shape
        return torch.zeros(shape, dtype=F32, device=self.device)

    @contextlib.contextmanager
    def _on_device(self):
        """Run the body on the engine's device and stream (CUDA state is
        per thread in PyTorch: the pump's thread starts on device 0 and
        the default stream)."""
        if self._stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    # ------------------------------------------------------- step protocol

    def _ingest_one(self, cs: CoreState, ev: ExternalEvents):
        """Apply observed events: the simulated step's arithmetic
        (``observe_events``) with the random draw replaced by the
        observation — the same death clamping, greedy slot-order grants
        against capacity, conjugate belief updates and telemetry fold."""
        shape = ((self.n_c,) if self.fleet else ()) + (self.base.max_slots,)
        leaves = {}
        for name, dtype in (("core_deaths", F32), ("spont_death", torch.bool),
                            ("scaleout_cores", F32), ("n_scaleouts", F32)):
            x = torch.from_numpy(np.array(_host(getattr(ev, name))))
            if tuple(x.shape) != shape:
                raise ValueError(f"events.{name} has shape "
                                 f"{tuple(x.shape)}, the slot table {shape}")
            leaves[name] = x.to(device=self.device, dtype=dtype,
                                non_blocking=True)
        return self.core.observe_events(cs, StepEvents(**leaves), self._caps)

    def _fleet_generators(self, gen: torch.Generator) -> list:
        """The C + 1 generators ``make_fleet_run`` derives from ``gen``
        (derived once for a generator the ticks keep passing)."""
        if self._gens is None or self._gens[0] is not gen:
            self._gens = (gen, fleet_generators(gen, self.n_c))
        return self._gens[1]

    def tick(self, gen: Optional[torch.Generator] = None,
             events: Optional[ExternalEvents] = None):
        """Advance cluster dynamics one ``dt``-hour window.

        Closes the previous decision window (folding its counters into the
        metric accumulators), refreshes the aggregate curves when the
        blocked ``agg_refresh_steps`` schedule says so, then applies this
        window's deaths / scale-out grants / belief updates — drawn from
        the fitted processes with ``gen`` (on the engine's device; the
        draws ``make_run``'s step makes, in its order; a fleet's clusters
        and router from ``gen``'s ``fleet_generators``, as
        ``make_fleet_run``'s step draws them), or observed via ``events``.
        """
        if (gen is None) == (events is None):
            raise ValueError("tick() needs exactly one of gen= or events=")
        with self._state_lock, self._on_device():
            self._close_window()
            if self.ticks % self.k_refresh == 0 and not self.naive:
                with annotate("repro.engine.refresh"):
                    self._cs = self.core.refresh_aggregates(self._cs)
                self.n_refreshes += 1
            with annotate("repro.engine.tick"):
                if events is not None:
                    self._cs, self._out = self._ingest_one(self._cs, events)
                    self._window_seed = window_seed(self.seed, self.ticks)
                    if self.fleet:
                        self._route_gen = torch.Generator(
                            device=self.device).manual_seed(
                                self._window_seed)
                elif self.fleet:
                    gens = self._fleet_generators(gen)
                    ev = _sample_tables(self.core, gens[:self.n_c],
                                        self._cs.slots)
                    self._cs, self._out = self.core.observe_events(
                        self._cs, ev, self._caps)
                    self._route_gen = gens[self.n_c]
                    self._window_seed = None
                else:
                    self._cs, self._out = self.core.apply_events(gen,
                                                                 self._cs)
                    self._window_seed = None
            self._util = self._out.util
            self._acc, self._rej = self._zero_counts(), self._zero_counts()
            self.ticks += 1

    def _close_window(self):
        with self._state_lock, self._on_device():
            if self._out is None:
                return
            slots, util_end = _accumulate_step(
                self._cs.slots, self._out, self._acc, self._rej,
                self.base.dt)
            self._cs = self._cs._replace(slots=slots)
            self._util_trace.append(util_end)
            self._fail_trace.append(self._out.failed)
            self._out = None
            # zero the folded window counters so a second close (metrics()
            # followed by tick()) cannot double-count them
            self._acc, self._rej = self._zero_counts(), self._zero_counts()

    # ------------------------------------------------- micro-batch frontend

    def submit(self, arrival: Arrival) -> Future:
        """Enqueue one admission request; resolves to ``bool`` (admitted)
        at the next ``flush``. Thread-safe and device-free: callers hand
        over numpy scalars, the flushing thread does the device work."""
        fut: Future = Future()
        with self._lock:
            self._pending.append((arrival, fut, time.monotonic()))
            self._work.notify()
        return fut

    @property
    def n_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def flush(self) -> int:
        """Decide every pending request in fixed-width micro-batches (or one
        by one on the naive ablation path); resolves their futures. Returns
        the number of decisions made.

        The whole drain runs under ``_state_lock``: the window check and
        the decides it gates are one critical section, so a concurrent
        ``tick()``/``metrics()`` cannot close the window mid-flight. A chunk
        that raises fails every remaining future with the exception instead
        of leaving callers blocked forever."""
        with self._state_lock:
            if self._out is None:
                raise RuntimeError("flush() before the first tick()")
            with self._lock:
                pending, self._pending = self._pending, []
            if not pending:
                return 0
            chunk = 1 if self.naive else self.width
            t0 = time.monotonic()
            done = 0
            try:
                with annotate("repro.engine.flush"):
                    for i in range(0, len(pending), chunk):
                        part = pending[i:i + chunk]
                        accept = self._decide([a for a, _, _ in part])
                        self._trace_part(part, accept)
                        for (_, fut, _), ok in zip(part, accept):
                            fut.set_result(bool(ok))
                        done = i + len(part)
            except BaseException as exc:
                for _, fut, _ in pending[done:]:
                    if not fut.done():
                        fut.set_exception(exc)
                raise
            cost = time.monotonic() - t0
            self._flush_cost_s = (cost if self._flush_cost_s == 0.0
                                  else 0.8 * self._flush_cost_s + 0.2 * cost)
            self.n_flushes += 1
        return len(pending)

    def _trace_part(self, part: list, accept: np.ndarray) -> None:
        """Record one decided micro-batch chunk: submit→decision latency
        into the host histogram, plus (when a tracer is attached) one
        structured record per decision with the policy score/threshold from
        the traced decide path. The diagnostics are copied to the host once
        per chunk, before the record loop: indexing the device tensors per
        record would cost one device-to-host sync per decision."""
        t_dec = time.monotonic()
        diag = self._last_diag
        if diag is not None and self.tracer is not None:
            with self._on_device():
                host = torch.stack([diag.fits.to(F32), diag.score,
                                    diag.threshold]).cpu().numpy()
            diag = diag._replace(fits=host[0] != 0.0, score=host[1],
                                 threshold=host[2])
        with self._state_lock:
            self._hist_batch.observe(float(len(part)))
            for j, ((_, _, t_sub), ok) in enumerate(zip(part, accept)):
                lat = t_dec - t_sub
                self._hist_latency.observe(lat)
                if self.flush_slo_s is not None and lat > self.flush_slo_s:
                    self.deadline_misses += 1
                if self.tracer is None:
                    continue
                self._req_id += 1
                rec = dict(step=self.ticks, req_id=self._req_id,
                           policy_kind=self._policy_info["kind"],
                           verdict=bool(ok), latency_s=lat,
                           batch_size=len(part))
                if diag is not None:
                    rec["score"] = diag.score[j]
                    rec["threshold"] = diag.threshold[j]
                    rec["fits"] = diag.fits[j]
                else:
                    rec["threshold"] = self._policy_info["threshold"]
                self.tracer.record(**rec)

    def decide_slice(self, stream_t: ArrivalStream, valid,
                     route_draws=None) -> np.ndarray:
        """Decide one pre-stacked width-``micro_batch`` arrival slice (the
        path the equivalence tests and the card's smoke drive; ``submit`` +
        ``flush`` stack onto exactly this). ``stream_t`` has [A] leaves
        (tensors or numpy), ``valid`` is an [A] mask. Returns the [A] accept
        mask, read back to the host once (for fleets: OR over the
        per-cluster [C, A] decisions). A fleet's router draws from the
        window's router generator, or takes ``route_draws`` (its ``draw``
        result, e.g. another package's draws)."""
        valid = _host(valid).astype(bool)
        n_valid = int(valid.sum())
        with self._state_lock, self._on_device():
            # checked under the lock: a concurrent tick()/metrics() closing
            # the window flips _out to None mid-flight otherwise
            if self._out is None:
                raise RuntimeError("decide_slice() before the first tick()")
            stream_t = _to_device(stream_t, self.device)
            valid_t = torch.from_numpy(valid).to(self.device,
                                                 non_blocking=True)
            self._last_diag = None
            core, cs = self.core, self._cs
            if self.naive:
                # ablation: full O(slots * grid) aggregate recompute, then a
                # width-1 decision — the cost of admission without the
                # incrementally-maintained aggregate
                cs = core.refresh_aggregates(cs)
            cand = core.candidates(core.candidate_rows(stream_t))
            if self.fleet:
                cs, accept = self._route_and_admit(cs, cand, stream_t,
                                                   valid_t, route_draws)
            elif self.tracer is not None and not self.naive:
                cs, accept, self._last_diag = core.decide_batch_traced(
                    self.policy, cs, self._util, cand, stream_t, valid_t)
            else:
                cs, accept = core.decide_batch(self.policy, cs, self._util,
                                               cand, stream_t, valid_t)
            # post-placement utilization, so a second flush inside the
            # same window admits against the already-placed arrivals
            self._util = torch.sum(cs.slots.cores * cs.slots.alive.to(F32),
                                   dim=-1)
            self._cs = cs
            accept = accept.cpu().numpy()
            if not self.fleet:
                n_acc = float(np.sum(accept))
                self._acc += n_acc
                self._rej += n_valid - n_acc
            self.decisions += n_valid
        return accept

    def _route_and_admit(self, cs: CoreState, cand: MomentCurves,
                         stream_t: ArrivalStream, valid_t: torch.Tensor,
                         route_draws):
        """A fleet's slice: route it on the running per-cluster state, then
        admit per cluster (``make_fleet_run``'s step), counting on the
        device. Returns (cs, the [A] OR of the [C, A] decisions)."""
        n_c = self.n_c
        ctx = RouteContext(cand=cand, c0=stream_t.c0, valid=valid_t,
                           agg_el=cs.agg_el, agg_vl=cs.agg_vl,
                           util=self._util, capacities=self._caps,
                           policy=self.policy)
        draws = (self.router.draw(self._route_gen, ctx) if route_draws is None
                 else tree_to(route_draws, self.device))
        assign = torch.clamp(self.router.assign(ctx, draws), 0, n_c)
        clusters = torch.arange(n_c, device=self.device)
        mask = valid_t & (assign == clusters[:, None])          # [C, A]
        cand_c = MomentCurves(*(x.expand(n_c, *x.shape) for x in cand))
        cs, accept = self.core.decide_batch(self.policy, cs, self._util,
                                            cand_c,
                                            _to_clusters(stream_t, n_c), mask)
        n_acc = torch.sum(accept.to(F32), dim=-1)
        self._acc = self._acc + n_acc
        self._rej = self._rej + (torch.sum(mask.to(F32), dim=-1) - n_acc)
        self._rej_all = self._rej_all + torch.sum(
            (valid_t & (assign == n_c)).to(F32))
        return cs, torch.any(accept, dim=0)

    def _decide(self, arrivals: list) -> np.ndarray:
        """Stack ``Arrival`` tickets into one padded fixed-width slice: one
        float32 array of the tickets' leaves, one copy to the device."""
        n = len(arrivals)
        width = 1 if self.naive else self.width
        packed = np.array([self._lane(a) for a in arrivals]
                          + [self._pad] * (width - n), dtype=np.float32)
        with self._on_device():
            rows = torch.from_numpy(np.ascontiguousarray(packed.T)).to(
                self.device, non_blocking=True)
        valid = np.arange(width) < n
        return self.decide_slice(_unpack(rows.unbind(0), n), valid)[:n]

    @staticmethod
    def _lane(a: Arrival) -> list:
        """A ticket's float leaves in the order ``_unpack`` reads them."""
        return [a.c0, *a.params, *a.bel, *a.bel_alt]

    def _pad_lane(self) -> list:
        bel = list(map(_host, belief_from_prior(self.base.priors, ())))
        return [1.0, 0.0, 1.0, 0.0, *bel, *bel]   # c0, lam, mu, sig, ...

    # ------------------------------------------------------------ async pump

    def start(self, interval_s: float = 0.001):
        """Run the flush loop on a background thread: concurrent submitters
        get their futures resolved as the engine coalesces the queue.

        Without ``flush_slo_ms`` this is the plain pump (poll every
        ``interval_s``, drain whatever is queued). With ``flush_slo_ms`` set
        it is the deadline scheduler (``_deadline_loop``): fire a full
        micro-batch the moment ``width`` requests are pending, otherwise
        fire a partial batch when the oldest pending request approaches its
        latency SLO."""
        if self._pump is not None:
            raise RuntimeError("engine pump already running")
        self._stop.clear()
        target = (self._deadline_loop if self.flush_slo_s is not None
                  else lambda: self._pump_loop(interval_s))
        self._pump = threading.Thread(target=target, daemon=True)
        self._pump.start()

    def _pump_loop(self, interval_s: float):
        while not self._stop.is_set():
            t0 = time.monotonic()
            if self.n_pending:
                self.flush()
                self._pump_busy_s += time.monotonic() - t0
            else:
                self._stop.wait(interval_s)
                self._pump_idle_s += time.monotonic() - t0

    def _deadline_loop(self):
        """Latency-SLO-aware flush scheduler. Each ``submit()`` stamps its
        enqueue time; the oldest pending request's implicit deadline is
        ``t_sub + flush_slo_s``. Under load the width trigger fires full
        micro-batches (max throughput); at low rate the deadline trigger
        fires a partial batch a safety margin before the oldest request's
        deadline, where the margin is an EWMA of observed flush cost (so
        decisions land before — not at — the SLO) floored at 5% of the SLO.

        The condition's lock is released before flushing: ``flush()`` takes
        ``_state_lock`` then ``_lock``, and ``metrics_snapshot`` holds
        ``_state_lock`` while reading ``n_pending`` — flushing while holding
        ``_lock`` would invert that ordering and deadlock."""
        slo = self.flush_slo_s
        while not self._stop.is_set():
            fire = False
            with self._work:
                while not self._stop.is_set() and not fire:
                    if len(self._pending) >= self.width:
                        fire = True
                    elif self._pending:
                        margin = max(2.0 * self._flush_cost_s, 0.05 * slo)
                        due = self._pending[0][2] + slo - margin
                        wait = due - time.monotonic()
                        if wait <= 0.0:
                            fire = True
                        else:
                            self._work.wait(wait)
                    else:
                        t0 = time.monotonic()
                        self._work.wait()
                        self._pump_idle_s += time.monotonic() - t0
            if fire:
                t0 = time.monotonic()
                self.flush()
                self._pump_busy_s += time.monotonic() - t0

    def stop(self):
        if self._pump is None:
            return
        self._stop.set()
        with self._work:
            self._work.notify_all()
        self._pump.join()
        self._pump = None
        self.flush()

    # -------------------------------------------------------------- metrics

    def metrics(self):
        """Run-so-far metrics on the engine's device, assembled as
        ``make_run`` assembles its own (same helpers, same arithmetic):
        ``RunMetrics`` for a single cluster, ``FleetMetrics`` for a fleet.
        After ``n_steps`` ticks over ``make_run``'s (``make_fleet_run``'s)
        generator and stream these equal its result bit for bit."""
        with self._state_lock, self._on_device():
            self._close_window()
            n_t = len(self._util_trace)
            horizon = (self.base.horizon_hours if n_t == self.base.n_steps
                       else max(n_t, 1) * self.base.dt)
            if n_t:
                util_trace = torch.stack(self._util_trace, dim=-1)
                fail_trace = torch.stack(self._fail_trace, dim=-1)
            else:
                shape = (self.n_c, 0) if self.fleet else (0,)
                util_trace = fail_trace = torch.zeros(shape,
                                                      device=self.device)
            if not self.fleet:
                return _run_metrics(self.base, self._cs.slots, util_trace,
                                    fail_trace, horizon_hours=horizon)
            return _fleet_metrics(self.base, self._caps, self._cs.slots,
                                  util_trace, fail_trace, self._rej_all,
                                  horizon_hours=horizon)

    def metrics_snapshot(self) -> dict:
        """Non-blocking observability snapshot: engine counters, the
        decision-latency / flush-batch-size host histograms, and (with
        ``cfg.telemetry``) the device telemetry rider's summary.

        Unlike ``metrics()`` this never closes the open window, never
        flushes, and never synchronizes with the pump: it holds the state
        lock only long enough to enqueue a clone of the rider (on the
        engine's stream) and to snapshot the host histograms, then reads the
        clone outside the lock — a Prometheus scrape cannot stall
        admission. Safe from any thread."""
        with self._state_lock:
            tel = self._cs.tel
            with self._on_device():
                tel_copy = (TelemetryState(*(x.clone() for x in tel))
                            if tel is not None else None)
            idle, busy = self._pump_idle_s, self._pump_busy_s
            eng = {
                "n_requests": self.decisions,
                "n_flushes": self.n_flushes,
                "n_refreshes": self.n_refreshes,
                "n_ticks": self.ticks,
                "queue_depth": self.n_pending,
                "pump_idle_fraction": (idle / (idle + busy)
                                       if idle + busy > 0 else 0.0),
                "decision_latency_seconds": self._hist_latency.snapshot(),
                "flush_batch_size": self._hist_batch.snapshot(),
                "deadline_misses": self.deadline_misses,
                "flush_slo_ms": (0.0 if self.flush_slo_s is None
                                 else self.flush_slo_s * 1e3),
                "n_shards": self.n_shards,
            }
        snap = {"engine": eng}
        if tel_copy is not None:
            with self._on_device():
                snap["telemetry"] = telemetry_summary(tel_copy)
        return snap


def _to_device(stream_t: ArrivalStream, device) -> ArrivalStream:
    """An [A] arrival slice with tensor or numpy leaves, on ``device``."""
    def leaf(x):
        if isinstance(x, tuple):
            return type(x)(*map(leaf, x))
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        return x.to(device)
    return leaf(stream_t)


def _unpack(rows, n: int) -> ArrivalStream:
    """The arrival slice of ``_decide``'s packed rows (``_lane``'s order:
    c0, params, bel, bel_alt), each a [width] row of one tensor, so that a
    chunk's tickets reach the device in one copy; ``n`` lanes are valid."""
    n_p, n_b = len(DeploymentParams._fields), len(GammaBelief._fields)
    return ArrivalStream(
        params=DeploymentParams(*rows[1:1 + n_p]), c0=rows[0],
        bel=GammaBelief(*rows[1 + n_p:1 + n_p + n_b]),
        bel_alt=GammaBelief(*rows[1 + n_p + n_b:]),
        n_arrivals=torch.tensor(n, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Tuned operating points: committed BENCH_<scale>.json rows as the source of
# the daemon's default thresholds (read as data, as the JAX package reads
# them; no simulation).
# ---------------------------------------------------------------------------

OPERATING_ROW_PREFIX = "serve"

_OP_RE = re.compile(r"theta=(?P<th>[-\d.e+]+) capacity=(?P<cap>[-\d.e+]+)"
                    r" tau=(?P<tau>[-\d.e+]+)")


def operating_row_name(scale_name: str, kind_name: str) -> str:
    return f"{OPERATING_ROW_PREFIX}/{scale_name}/operating_point/{kind_name}"


def format_operating_derived(theta: float, capacity: float,
                             tau: float) -> str:
    return f"theta={theta:.6g} capacity={capacity:.6g} tau={tau:.3g}"


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """A tuned (theta, capacity, tau) admission operating point recorded in
    a BENCH artifact. ``theta`` is the threshold (zeroth/first, in cores —
    rescaled linearly when serving a different capacity) or rho (second,
    scale-free)."""

    kind_name: str
    theta: float
    capacity: float
    tau: float

    def theta_for(self, capacity: float) -> float:
        if self.kind_name == "second":
            return self.theta
        return self.theta * (capacity / self.capacity)


def load_operating_point(kind_name: str, scale_name: str = "quick",
                         bench_path: Optional[str] = None
                         ) -> Optional[OperatingPoint]:
    """Read the tuned operating point for a policy kind from the committed
    ``BENCH_<scale>.json`` (or ``bench_path`` / ``$REPRO_BENCH_JSON``).
    Returns ``None`` when no row exists — callers fall back to their
    hand-picked constants (and should warn)."""
    path = bench_path or os.environ.get("REPRO_BENCH_JSON") or os.path.join(
        _REPO_ROOT, f"BENCH_{scale_name}.json")
    try:
        with open(path, encoding="utf-8") as f:
            rows = json.load(f).get("rows", [])
    except (OSError, ValueError):
        return None
    name = operating_row_name(scale_name, kind_name)
    for row in rows:
        if row.get("name") != name:
            continue
        m = _OP_RE.match(row.get("derived", ""))
        if m:
            return OperatingPoint(kind_name=kind_name, theta=float(m["th"]),
                                  capacity=float(m["cap"]),
                                  tau=float(m["tau"]))
    return None


def default_policy_param(kind_name: str, capacity: float,
                         scale_name: str = "quick",
                         bench_path: Optional[str] = None) -> float:
    """The daemon's default threshold/rho: the tuned operating point from
    the committed BENCH artifact, rescaled to ``capacity``; the hand-picked
    constants (0.15 / 0.7 * capacity) only as a warned fallback."""
    op = load_operating_point(kind_name, scale_name, bench_path)
    if op is not None:
        return op.theta_for(capacity)
    warnings.warn(
        f"no tuned operating point for policy {kind_name!r} at scale "
        f"{scale_name!r}; falling back to hand-picked constants",
        stacklevel=2)
    return 0.15 if kind_name == "second" else 0.7 * capacity
