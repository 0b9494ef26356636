"""Trace replay: a ``WorkloadTrace`` as the simulator's ``ArrivalSource``.

``trace_to_stream`` buckets the trace's (sorted) arrivals into simulator
steps, caps each step at ``cfg.max_arrivals`` (overflow arrivals are
dropped and counted — widen ``max_arrivals`` or shrink ``dt`` if the count
is material), and scatters deployments into the ``[n_steps, max_arrivals]``
pre-drawn layout of ``ArrivalStream`` in one vectorized pass. The step loop
then treats replayed and prior-sampled runs identically: run-to-run
randomness (deaths, scale-out timing) still comes from the run's generator,
while *who arrives when, asking for how much, with what latent parameters*
comes from the trace.

Latent parameters drive the within-run event sampling. When the trace
lacks them (a real observed trace), per-deployment conjugate posterior
means under ``cfg.priors`` are imputed from the trace's observables —
exactly the Gamma updates of ``core.belief``, applied trace-side.

Information models (``cfg.prior_mode``) are all supported on replay:

  * GLOBAL — belief = population prior + the C0 size observation (no
    per-run randomness, so the stream is fully determined by the trace).
  * PSEUDO (§6) — the provider holds deployment-specific prior knowledge.
    Two constructions, selected by ``pseudo_source``:
      - ``"latent"`` (synthetic traces): sample ``cfg.n_pseudo_obs``
        pseudo observations from the trace's own latent parameters with
        ``core.processes.sample_pseudo_observations`` — the same law as
        ``draw_arrival_stream``'s PSEUDO path.
      - ``"observed"`` (real traces): form deterministic pseudo-counts
        from the trace's logged observables via
        ``core.belief.pseudo_counts_from_observables`` and the conjugate
        updates. ``n_pseudo_obs`` is ignored (the trace defines its own
        information content), though ``_validate_config`` still requires
        it >= 1 under PSEUDO.
  * MIX_LABELED / MIX_UNLABELED (§7) — the submitted deployment is the
    trace row (belief as in PSEUDO); the alternative user type, which a
    bare trace cannot carry, is imputed as an independent draw from
    ``cfg.priors`` with its own ``n_pseudo_obs`` pseudo observations —
    the same imputation ``draw_arrival_stream`` uses for its alt type.

PSEUDO-latent and the §7 modes draw from the generator passed to
``trace_to_stream`` / ``ArrivalSource.stream`` for the belief side only,
in this order: the trace rows' pseudo observations, the alternative type's
parameters, its pseudo observations. Arrivals remain trace-determined.

PyTorch counterpart of ``repro.traces.replay``. The JAX package scatters
with ``mode="drop"``; here every arrival that is not placed is written to
one extra slot past the layout, which is then cut off. A stream is built
on the trace's device; ``TraceArrivalSource`` keeps a copy of its trace on
each device a run asks for.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.belief import (apply_pseudo_observations, belief_from_prior,
                           observe_initial_size,
                           pseudo_counts_from_observables)
from ..core.processes import (F32, DeploymentParams, PopulationPriors,
                              PseudoObservations, sample_params,
                              sample_pseudo_observations)
from ..sim.core import (GLOBAL, MIX_LABELED, MIX_UNLABELED, PSEUDO,
                        ArrivalSource, ArrivalStream, SimConfig,
                        _validate_config, stream_config)
from .schema import WorkloadTrace, has_latents, trace_to, validate_trace

PSEUDO_LATENT, PSEUDO_OBSERVED, PSEUDO_AUTO = "latent", "observed", "auto"


class ReplayDraws(NamedTuple):
    """The belief-side draws of a PSEUDO-latent or §7 replay, handed to
    ``trace_to_stream`` in place of its own (the counterpart of
    ``make_run``'s ``events=``): ``own`` the trace rows' [D] pseudo
    observations (None: formed or drawn as usual), ``alt`` the §7
    alternative type's [T, A] parameters and ``alt_obs`` its pseudo
    observations."""

    own: Optional[PseudoObservations] = None
    alt: Optional[DeploymentParams] = None
    alt_obs: Optional[PseudoObservations] = None


def params_from_trace(trace: WorkloadTrace,
                      priors: PopulationPriors) -> DeploymentParams:
    """Per-deployment latents; conjugate posterior means where missing.

    mu | data  ~ Gamma(a + deaths, b + core-hours);  sig from the size
    observations (C0 plus scale-out sizes); lam from the scale-out counts
    with the E[mu**nu]-style exposure approximated at the posterior-mean mu
    (same E-step shortcut as ``core.belief``).
    """
    deaths = trace.n_core_deaths
    mu_post = (priors.mu_shape + deaths) / (priors.mu_rate + trace.core_hours)
    sig_post = (priors.sig_shape + (trace.c0 - 1.0)
                + (trace.scaleout_cores - trace.n_scaleouts)) / (
                    priors.sig_rate + 1.0 + trace.n_scaleouts)
    lam_post = (priors.lam_shape + trace.n_scaleouts) / (
        priors.lam_rate + mu_post ** priors.nu * trace.obs_window)
    pick = lambda latent, post: torch.where(
        torch.isfinite(latent) & (latent > 0.0), latent, post)
    return DeploymentParams(
        lam=pick(trace.lam, lam_post),
        mu=pick(trace.mu, mu_post),
        sig=torch.where(torch.isfinite(trace.sig), trace.sig, sig_post),
    )


def _resolve_pseudo_source(trace: WorkloadTrace, pseudo_source: str) -> str:
    if pseudo_source not in (PSEUDO_LATENT, PSEUDO_OBSERVED, PSEUDO_AUTO):
        raise ValueError(f"unknown pseudo_source {pseudo_source!r}")
    if pseudo_source != PSEUDO_AUTO:
        return pseudo_source
    return PSEUDO_LATENT if has_latents(trace) else PSEUDO_OBSERVED


def _needs_gen(cfg: SimConfig, source: str) -> bool:
    """Does the stream draw anything (PSEUDO-latent, the §7 modes)?"""
    return cfg.prior_mode != GLOBAL and (
        source == PSEUDO_LATENT or cfg.prior_mode in (MIX_LABELED,
                                                      MIX_UNLABELED))


def _trace_pseudo_obs(trace: WorkloadTrace, cfg: SimConfig, source: str,
                      gen: Optional[torch.Generator]) -> PseudoObservations:
    """[D]-shaped pseudo observations for the trace's own deployments."""
    if source == PSEUDO_OBSERVED:
        return pseudo_counts_from_observables(
            core_deaths=trace.n_core_deaths,
            exposure_core_hours=trace.core_hours,
            n_scaleouts=trace.n_scaleouts,
            scaleout_cores=trace.scaleout_cores,
            window_hours=trace.obs_window,
        )
    if gen is None:
        raise ValueError(
            f"prior_mode={cfg.prior_mode!r} with pseudo_source='latent' "
            "samples pseudo observations and needs a generator: pass gen= "
            "to trace_to_stream (TraceArrivalSource forwards its run's)")
    params = DeploymentParams(lam=trace.lam, mu=trace.mu, sig=trace.sig)
    return sample_pseudo_observations(gen, params, cfg.priors,
                                      cfg.n_pseudo_obs)


def trace_to_stream(trace: WorkloadTrace, cfg: SimConfig,
                    gen: Optional[torch.Generator] = None,
                    pseudo_source: str = PSEUDO_AUTO, *,
                    draws: Optional[ReplayDraws] = None,
                    ) -> tuple[ArrivalStream, torch.Tensor]:
    """Scatter a trace into the simulator's pre-drawn arrival layout, on the
    trace's device.

    Returns ``(stream, n_dropped)`` where ``n_dropped`` (a 0-d tensor) counts
    arrivals lost to the per-step ``max_arrivals`` cap (arrivals beyond
    ``cfg``'s horizon are simply outside the replayed window and not counted
    as drops).

    ``gen`` (a ``torch.Generator`` on the trace's device) feeds the
    belief-side sampling of the PSEUDO-latent and §7 modes (see the module
    docstring); GLOBAL and PSEUDO-observed replay is deterministic and
    ignores it. ``draws`` hands in those draws instead.

    ``cfg`` may be a ``FleetConfig``: the trace is scattered into ONE
    fleet-wide stream (the fleet's base layout via ``stream_config``) and
    arrivals are *routed* to clusters at simulation time by
    ``make_fleet_run``'s router — a trace never pre-assigns clusters.
    """
    cfg = stream_config(cfg)
    _validate_config(cfg)
    # the cumulative-rank scatter below assumes sorted valid arrivals
    validate_trace(trace)
    draws = ReplayDraws() if draws is None else draws
    device = trace.arrival_hours.device
    t_steps, a_max = cfg.n_steps, cfg.max_arrivals
    # a tensor divisor: CUDA divides by a Python number as a multiply by its
    # reciprocal, which can put an arrival in the step before
    dt = torch.tensor(cfg.dt, dtype=trace.arrival_hours.dtype, device=device)
    step = torch.floor(trace.arrival_hours / dt).to(torch.int32)
    ok = trace.valid & (trace.arrival_hours < cfg.horizon_hours) & (step >= 0)
    step_c = torch.clamp(step, 0, t_steps - 1).long()

    occ = ok.to(torch.int64)
    counts = torch.zeros(t_steps, dtype=torch.int64,
                         device=device).index_add_(0, step_c, occ)
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                        torch.cumsum(counts, 0)[:-1]])
    rank = (torch.cumsum(occ, 0) - 1) - starts[step_c]   # order within step
    placed = ok & (rank < a_max)
    n_dropped = torch.sum((ok & ~placed).to(torch.int32))
    # arrivals not placed land in one extra slot, cut off below
    flat = torch.where(placed, step_c * a_max + rank, t_steps * a_max)

    def scatter(x, fill):
        out = torch.full((t_steps * a_max + 1,), fill, dtype=x.dtype,
                         device=device)
        out[flat] = x
        return out[:-1].reshape(t_steps, a_max)

    params = params_from_trace(trace, cfg.priors)
    params = DeploymentParams(lam=scatter(params.lam, 0.0),
                              mu=scatter(params.mu, 1.0),
                              sig=scatter(params.sig, 0.0))
    c0 = scatter(trace.c0.to(F32), 1.0)
    n_arrivals = torch.clamp(counts, max=a_max).to(torch.int32)

    prior = belief_from_prior(cfg.priors, (t_steps, a_max), device=device)
    if cfg.prior_mode == GLOBAL:
        bel = prior
        bel_alt = bel
    else:
        source = _resolve_pseudo_source(trace, pseudo_source)
        obs = (draws.own if draws.own is not None
               else _trace_pseudo_obs(trace, cfg, source, gen))
        # scatter the [D] pseudo-counts into the [T, A] layout (empty slots
        # get zero counts, i.e. the bare prior) and fold them in through the
        # conjugate update — the same path draw_arrival_stream takes
        obs = PseudoObservations(*(scatter(f.to(F32), 0.0) for f in obs))
        bel = apply_pseudo_observations(prior, obs, cfg.priors)
        if cfg.prior_mode == PSEUDO:
            bel_alt = bel
        else:
            # §7: the alternative user type is not in the trace; impute it
            # as an independent prior draw with its own pseudo observations,
            # mirroring draw_arrival_stream's alt-type construction
            if draws.alt is None and gen is None:
                raise ValueError(
                    f"prior_mode={cfg.prior_mode!r} imputes the §7 "
                    "alternative type and needs a generator: pass gen= to "
                    "trace_to_stream (TraceArrivalSource forwards its run's)")
            alt = (draws.alt if draws.alt is not None else
                   sample_params(gen, cfg.priors, (t_steps, a_max)))
            obs_alt = (draws.alt_obs if draws.alt_obs is not None else
                       sample_pseudo_observations(gen, alt, cfg.priors,
                                                  cfg.n_pseudo_obs))
            bel_alt = apply_pseudo_observations(prior, obs_alt, cfg.priors)
    bel = observe_initial_size(bel, c0)
    return ArrivalStream(params=params, c0=c0, bel=bel, bel_alt=bel_alt,
                         n_arrivals=n_arrivals), n_dropped


class TraceArrivalSource(ArrivalSource):
    """Replay a fixed ``WorkloadTrace`` through ``make_run``.

    The run's generator no longer influences *arrivals* (they are the
    trace) — under GLOBAL and PSEUDO-observed replay every run shares the
    whole arrival stream (``shares_stream``: a batch builds it once), which
    is the trace-driven evaluation mode of the benchmarks. Under
    PSEUDO-latent and the §7 modes the generator still drives the
    belief-side sampling (pseudo observations, imputed alt type), matching
    ``PriorArrivalSource``'s per-run belief randomness.

    ``pseudo_source`` (default ``"auto"``) picks how PSEUDO/§7 beliefs are
    built: ``"latent"`` samples from the trace's latent parameters,
    ``"observed"`` forms conjugate pseudo-counts from the logged
    observables; ``"auto"`` resolves at construction from
    ``has_latents(trace)``.
    """

    def __init__(self, trace: WorkloadTrace, pseudo_source: str = PSEUDO_AUTO):
        self.trace = validate_trace(trace)
        self.pseudo_source = _resolve_pseudo_source(trace, pseudo_source)
        self._copies = {trace.arrival_hours.device: trace}

    def _trace_on(self, device) -> WorkloadTrace:
        device = torch.device(device)
        if device not in self._copies:
            self._copies[device] = trace_to(self.trace, device)
        return self._copies[device]

    def shares_stream(self, cfg: SimConfig) -> bool:
        """True when the stream does not depend on the run's generator."""
        return not _needs_gen(stream_config(cfg), self.pseudo_source)

    def stream(self, gen: torch.Generator, cfg: SimConfig) -> ArrivalStream:
        stream, _ = trace_to_stream(self._trace_on(gen.device), cfg, gen=gen,
                                    pseudo_source=self.pseudo_source)
        return stream

    def n_dropped(self, cfg: SimConfig) -> int:
        """Arrivals lost to the max_arrivals cap under ``cfg`` (host value).

        Drops depend only on arrival placement, never on beliefs, so the
        count is taken under GLOBAL. ``cfg`` may be a ``FleetConfig`` (drops
        are a property of the fleet-wide stream layout, before routing).
        """
        cfg = stream_config(cfg)._replace(prior_mode=GLOBAL)
        return int(trace_to_stream(self.trace, cfg)[1])
