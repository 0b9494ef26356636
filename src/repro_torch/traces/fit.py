"""Recover ``PopulationPriors`` from a ``WorkloadTrace`` (generate→fit loop).

Two estimation paths, chosen by ``source``:

  * ``"latent"`` — the trace carries per-deployment (lam, mu, sig) (any
    synthetic trace does). Gamma hyperparameters come from the standard
    two-parameter Gamma MLE (Newton on the shape with the log-mean
    sufficient statistic); ``nu`` from the 1-d Poisson profile likelihood of
    the scale-out counts; ``delta`` from the censored-exponential MLE of the
    spontaneous-shutdown clock. This is the tight round-trip used by the
    acceptance test.
  * ``"observed"`` — only provider-visible observables are used, as with a
    real trace. Per-deployment point estimates (mu_hat = deaths/exposure,
    sig_hat from size observations, scale-out intensities N/(mu_hat**nu w))
    are *noisy*, so plain Gamma fits of them overestimate the population
    variance; the moment-matching here subtracts the known sampling-noise
    component (E Var[x_hat | x] has closed form for Poisson/exponential
    estimates) before converting moments to (shape, rate). ``nu`` comes from
    the log-log regression of binned scale-out intensity against mu_hat —
    E[N/w | mu] = E[lam] mu**nu is linear in log mu with slope nu.

The observed path is factored through an explicit **sufficient-statistics
layer** so it runs windowed/streaming over any trace (or the live engine's
telemetry stream):

  * ``window_stats(trace, t0, t1)`` reduces the deployments *arriving* in
    [t0, t1) to a ``FitStats`` record — counts, moment sums, and censoring
    tallies, all mergeable by addition. Windows that partition the horizon
    partition the deployments, so merging is exact (no approximation from
    windowing, only float summation order).
  * ``merge_stats(*stats)`` folds any number of windows into one record
    (associative, window-order-invariant up to float rounding).
  * ``stats_to_priors(stats)`` runs every population-level estimator on the
    merged record. ``fit_priors(source="observed")`` is literally
    ``stats_to_priors(window_stats(trace, 0, inf))`` — one window over the
    whole trace is bit-for-bit the batch fit.

Three estimators were restated in sufficient-statistic form to make the
record finite-dimensional (the round-trip accuracy test pins them):

  * nu's binned regression uses **fixed** log-mu bin edges instead of
    population quantiles (quantiles don't merge);
  * the scale-out-intensity (lam) moments are tabulated on the fixed
    ``NU_GRID`` — the fitted nu is snapped to the nearest grid point
    (0.01 resolution) — and restricted to deployments with an informative
    mu_hat, rather than imputing the population-mean fallback for
    death-free deployments (the fallback depends on the *merged* mu fit);
  * delta's exposure uses the ratio-of-sums Σ deaths·w/core_hours, which is
    unbiased for Σ mu·w under the generator (E[deaths] = mu · core_hours
    exactly) without needing the fitted mu prior per deployment.

A window too small for an estimator (``< _MIN_SAMPLES`` informative rows,
e.g. an empty window) **warns and continues** with a weakly-informative
exponential fallback for that channel — recorded under
``diag["degenerate"]`` — instead of raising, so streaming consumers survive
quiet windows.

Both paths return a fitted ``PopulationPriors`` plus a diagnostics dict.
Fitting is a cold path and runs in numpy/scipy on host.

PyTorch counterpart of ``repro.traces.fit``: the same float64 numpy/scipy
arithmetic, on the trace's columns read to the host once.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
from scipy.special import polygamma, psi

from ..core.processes import PopulationPriors
from ..obs.log import get_logger
from .schema import WorkloadTrace, has_latents, host

log = get_logger(__name__)

_MIN_SAMPLES = 8

#: fixed nu grid for the streaming lam moments (and the latent-path profile
#: default): 0.01 resolution over the physically sensible [0, 1.5] range
NU_GRID = np.linspace(0.0, 1.5, 151)

#: fixed log(mu_hat) bin edges for the streaming nu regression (out-of-range
#: values clip into the end bins); spans death rates 1e-4..30 per core-hour
_N_NU_BINS = 12
_NU_BIN_EDGES = np.linspace(np.log(1e-4), np.log(30.0), _N_NU_BINS + 1)


def fit_gamma_mle(x: np.ndarray, n_iter: int = 40) -> tuple[float, float]:
    """Two-parameter Gamma(shape, rate) MLE via Newton on the shape.

    Uses s = log(mean) - mean(log); the Greenwood–Durand-style initializer
    followed by Newton steps on  f(k) = log k - psi(k) - s.
    """
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x) & (x > 0)]
    if x.size < _MIN_SAMPLES:
        raise ValueError(f"gamma MLE needs >= {_MIN_SAMPLES} samples, got {x.size}")
    return _gamma_mle_from_moments(x.mean(), np.log(x).mean(), n_iter)


def _gamma_mle_from_moments(mean: float, meanlog: float,
                            n_iter: int = 40) -> tuple[float, float]:
    """The Gamma MLE Newton iteration from its two sufficient statistics."""
    s = np.log(mean) - meanlog
    s = max(s, 1e-9)
    k = (3.0 - s + np.sqrt((s - 3.0) ** 2 + 24.0 * s)) / (12.0 * s)
    for _ in range(n_iter):
        f = np.log(k) - psi(k) - s
        df = 1.0 / k - polygamma(1, k)
        step = f / df
        k_new = k - step
        if not np.isfinite(k_new) or k_new <= 0:
            k_new = k / 2.0
        if abs(k_new - k) < 1e-12 * k:
            k = k_new
            break
        k = k_new
    return float(k), float(k / mean)


def fit_gamma_moments(x: np.ndarray, noise_var: float = 0.0
                      ) -> tuple[float, float]:
    """Gamma(shape, rate) by moment matching, with the average *sampling*
    variance of the per-deployment estimates subtracted from the empirical
    variance (law of total variance: Var(x_hat) = Var(x) + E Var[x_hat|x])."""
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    if x.size < _MIN_SAMPLES:
        raise ValueError(f"moment fit needs >= {_MIN_SAMPLES} samples, got {x.size}")
    mean = x.mean()
    var = max(x.var() - noise_var, 1e-3 * mean * mean + 1e-12)
    return float(mean * mean / var), float(mean / var)


def _gamma_moments_from_sums(n: float, total: float, total_sq: float,
                             noise_var: float) -> tuple[float, float]:
    """``fit_gamma_moments`` from (count, sum, sum of squares)."""
    mean = total / n
    var = max(total_sq / n - mean * mean - noise_var,
              1e-3 * mean * mean + 1e-12)
    return float(mean * mean / var), float(mean / var)


# ---------------------------------------------------------------------------
# nu / delta estimators
# ---------------------------------------------------------------------------

def _fit_nu_profile(n_so, lam, mu, w, nu_grid) -> tuple[float, np.ndarray]:
    """Poisson profile log-likelihood of nu given true (lam, mu):
    N_i ~ Poisson(lam_i mu_i**nu w_i); terms without nu dropped."""
    logmu = np.log(mu)
    scores = np.array([
        np.sum(n_so * nu * logmu - lam * np.power(mu, nu) * w)
        for nu in nu_grid])
    return float(nu_grid[int(np.argmax(scores))]), scores


def _fit_delta(spont: np.ndarray, mu: np.ndarray, w: np.ndarray) -> float:
    """Censored-exponential MLE of the spontaneous-shutdown multiplier:
    T ~ Exp(delta * mu), observed exposure is mu-weighted window hours."""
    exposure = np.sum(mu * w)
    return float(spont.sum() / max(exposure, 1e-12))


# ---------------------------------------------------------------------------
# The sufficient-statistics layer (observed path, windowed/streaming)
# ---------------------------------------------------------------------------

class FitStats(NamedTuple):
    """Mergeable sufficient statistics of the observed-path prior fit over
    one arrival window. Every field is a float or a fixed-shape float64
    array and merges by addition (``t0``/``t1`` by min/max; ``min_deaths``
    is a parameter and must agree across merged windows)."""

    n: float              # valid deployments arriving in the window
    t0: float             # window bounds (arrival hours; diagnostics only)
    t1: float
    min_deaths: float     # informative-mu threshold the stats were built with
    # window observable totals (the drift-detector channels; keys mirror
    # obs.counters.telemetry_summary()["obs"])
    deaths_sum: float     # core deaths
    core_hours_sum: float  # core-hour exposure behind those deaths
    n_so_sum: float       # scale-out events
    so_cores_sum: float   # cores requested by scale-outs
    w_sum: float          # observation-window (alive) hours
    spont_sum: float      # spontaneous shutdowns
    dwh_sum: float        # Σ deaths·w/core_hours — delta's mu·w exposure
    # drift-detector channels: *unweighted* sums of per-deployment unbiased
    # estimates. E[deaths/core_hours | mu, window] = mu for any censoring, so
    # these window means are stationary across arrival windows of a
    # stationary trace — unlike the pooled ratio deaths_sum/core_hours_sum,
    # which horizon censoring tilts toward high-mu deployments near the end
    # of the trace (tuning.drift builds on this).
    ch_mu_sum: float      # Σ deaths/core_hours over rows with exposure
    ch_mu_n: float
    ch_so_sum: float      # Σ n_scaleouts/w over rows with alive hours
    ch_so_n: float
    # mu channel: censored-exponential per-deployment MLEs, informative rows
    mu_n: float
    mu_sum: float
    mu_logsum: float
    # sig channel: size-minus-one means over 1 + n_scaleouts observations
    sig_n: float
    sig_sum: float
    sig_sumsq: float
    inv_m_sum: float
    # nu channel: fixed log(mu_hat) bins of the scale-out intensity n_so/w
    nu_count: np.ndarray     # [_N_NU_BINS]
    nu_lm_sum: np.ndarray    # [_N_NU_BINS]
    nu_rate_sum: np.ndarray  # [_N_NU_BINS]
    # lam channel: intensity moments tabulated on the fixed NU_GRID
    lam_n: np.ndarray        # [len(NU_GRID)]
    lam_sum: np.ndarray      # [len(NU_GRID)]
    lam_sumsq: np.ndarray    # [len(NU_GRID)]
    inv_a_sum: np.ndarray    # [len(NU_GRID)]

    def observables(self) -> dict:
        """The window's observable totals under the same keys as
        ``obs.counters.telemetry_summary()["obs"]`` — the drift-detector
        input, whichever side (offline trace window / live telemetry delta)
        produced it."""
        return {
            "core_deaths": float(self.deaths_sum),
            "exposure_core_hours": float(self.core_hours_sum),
            "n_scaleouts": float(self.n_so_sum),
            "scaleout_cores": float(self.so_cores_sum),
            "alive_hours": float(self.w_sum),
            "spont_deaths": float(self.spont_sum),
        }

    def drift_channels(self) -> dict:
        """Censoring-robust per-window channel means for drift detection:
        ``mu`` (mean per-deployment death rate), ``scaleout`` (mean
        per-deployment scale-out intensity), ``size`` (mean size-minus-one).
        Channels with no contributing rows are NaN (the detector skips
        them)."""
        return {
            "mu": (self.ch_mu_sum / self.ch_mu_n if self.ch_mu_n > 0
                   else float("nan")),
            "scaleout": (self.ch_so_sum / self.ch_so_n if self.ch_so_n > 0
                         else float("nan")),
            "size": (self.sig_sum / self.sig_n if self.sig_n > 0
                     else float("nan")),
        }


def window_stats(trace: WorkloadTrace, t0: float = 0.0,
                 t1: float = np.inf, *, min_deaths: int = 2) -> FitStats:
    """Sufficient statistics over the deployments **arriving** in [t0, t1).

    Selecting by arrival time makes disjoint windows partition the valid
    deployments, so ``stats_to_priors(merge_stats(*windows))`` equals the
    batch fit over the concatenated trace (up to float summation order).
    Each deployment contributes its *whole* observation record to the window
    it arrives in — the streaming consumer sees a deployment once, when it
    shows up.
    """
    v = host(trace.valid)
    t = host(trace.arrival_hours).astype(np.float64)
    sel = v & (t >= t0) & (t < t1)
    w = host(trace.obs_window).astype(np.float64)[sel]
    n_so = host(trace.n_scaleouts).astype(np.float64)[sel]
    so_cores = host(trace.scaleout_cores).astype(np.float64)[sel]
    c0 = host(trace.c0).astype(np.float64)[sel]
    spont = host(trace.spont_death)[sel]
    deaths = host(trace.n_core_deaths).astype(np.float64)[sel]
    core_hours = host(trace.core_hours).astype(np.float64)[sel]

    mu_hat = np.where(core_hours > 0,
                      deaths / np.maximum(core_hours, 1e-12), np.nan)
    informative = np.isfinite(mu_hat) & (mu_hat > 0)
    ok_mu = (deaths >= min_deaths) & (core_hours > 0) & informative

    m_obs = 1.0 + n_so
    sig_hat = (c0 - 1.0 + (so_cores - n_so)) / m_obs

    # nu: fixed-edge bins over log(mu_hat) of the intensity n_so/w
    ok_nu = informative & (w > 0)
    lm = np.log(mu_hat[ok_nu])
    rate = n_so[ok_nu] / w[ok_nu]
    bins = np.clip(np.digitize(lm, _NU_BIN_EDGES) - 1, 0, _N_NU_BINS - 1)
    nu_count = np.bincount(bins, minlength=_N_NU_BINS).astype(np.float64)
    nu_lm_sum = np.bincount(bins, weights=lm, minlength=_N_NU_BINS)
    nu_rate_sum = np.bincount(bins, weights=rate, minlength=_N_NU_BINS)

    # lam: N/(mu_hat**nu w) moments for every candidate nu on the fixed grid
    mh, wv, ns = mu_hat[informative], w[informative], n_so[informative]
    a = np.power(mh[None, :], NU_GRID[:, None]) * wv[None, :]   # [G, M]
    ok_a = a > 1e-3
    inv_a = np.where(ok_a, 1.0 / np.maximum(a, 1e-12), 0.0)
    lam_hat = ns[None, :] * inv_a

    hpos = core_hours > 0
    dwh_sum = float(np.sum(deaths[hpos] * w[hpos] / core_hours[hpos]))

    wpos = w > 0
    ch_mu_sum = float(np.sum(deaths[hpos] / core_hours[hpos]))
    ch_so_sum = float(np.sum(n_so[wpos] / w[wpos]))

    return FitStats(
        n=float(sel.sum()), t0=float(t0), t1=float(t1),
        min_deaths=float(min_deaths),
        deaths_sum=float(deaths.sum()), core_hours_sum=float(core_hours.sum()),
        n_so_sum=float(n_so.sum()), so_cores_sum=float(so_cores.sum()),
        w_sum=float(w.sum()), spont_sum=float(spont.sum()), dwh_sum=dwh_sum,
        ch_mu_sum=ch_mu_sum, ch_mu_n=float(hpos.sum()),
        ch_so_sum=ch_so_sum, ch_so_n=float(wpos.sum()),
        mu_n=float(ok_mu.sum()), mu_sum=float(mu_hat[ok_mu].sum()),
        mu_logsum=float(np.log(mu_hat[ok_mu]).sum()) if ok_mu.any() else 0.0,
        sig_n=float(sig_hat.size), sig_sum=float(sig_hat.sum()),
        sig_sumsq=float(np.sum(sig_hat * sig_hat)),
        inv_m_sum=float(np.sum(1.0 / m_obs)),
        nu_count=nu_count, nu_lm_sum=nu_lm_sum, nu_rate_sum=nu_rate_sum,
        lam_n=ok_a.sum(axis=1).astype(np.float64),
        lam_sum=(lam_hat * ok_a).sum(axis=1),
        lam_sumsq=(lam_hat * lam_hat * ok_a).sum(axis=1),
        inv_a_sum=inv_a.sum(axis=1),
    )


def merge_stats(*stats: FitStats) -> FitStats:
    """Fold any number of window records into one (associative, and — since
    every field is a sum/min/max — invariant to window order up to float
    rounding). Windows must share ``min_deaths``."""
    if not stats:
        raise ValueError("merge_stats needs at least one FitStats")
    out = stats[0]
    for s in stats[1:]:
        if s.min_deaths != out.min_deaths:
            raise ValueError(
                f"cannot merge FitStats built with min_deaths="
                f"{out.min_deaths:g} and {s.min_deaths:g}")
        out = FitStats(
            n=out.n + s.n, t0=min(out.t0, s.t0), t1=max(out.t1, s.t1),
            min_deaths=out.min_deaths,
            **{f: getattr(out, f) + getattr(s, f)
               for f in FitStats._fields
               if f not in ("n", "t0", "t1", "min_deaths")})
    return out


def _degenerate_gamma(label: str, n: float, total: float,
                      diag: dict) -> tuple[float, float]:
    """Warn-and-continue fallback for a channel with too few informative
    samples (empty/quiet windows): a weakly-informative exponential
    (shape 1) matching the channel mean when one exists."""
    mean = total / n if n > 0 else float("nan")
    warnings.warn(
        f"observed fit: {label} channel has {int(n)} informative samples "
        f"(< {_MIN_SAMPLES}); continuing with a weakly-informative fallback",
        RuntimeWarning, stacklevel=3)
    log.warning("observed fit: %s channel degenerate (n=%d)", label, int(n))
    diag.setdefault("degenerate", []).append(label)
    rate = 1.0 / mean if np.isfinite(mean) and mean > 0 else 1.0
    return 1.0, float(rate)


def _nu_from_bins(stats: FitStats) -> float:
    """Weighted log-log regression slope over the fixed mu_hat bins
    (bins with < 4 rows or nonpositive mean intensity are dropped; fewer
    than 3 usable bins yields NaN → caller falls back)."""
    ok = (stats.nu_count >= 4) & (stats.nu_rate_sum > 0)
    if ok.sum() < 3:
        return float("nan")
    ws = stats.nu_count[ok]
    xs = stats.nu_lm_sum[ok] / ws
    ys = np.log(stats.nu_rate_sum[ok] / ws)
    xm = np.average(xs, weights=ws)
    ym = np.average(ys, weights=ws)
    return float(np.sum(ws * (xs - xm) * (ys - ym))
                 / np.sum(ws * (xs - xm) ** 2))


def stats_to_priors(stats: FitStats, *,
                    nu: float | None = None) -> tuple[PopulationPriors, dict]:
    """Run the observed-path population estimators on a (merged) record.

    ``nu`` fixes the exponent instead of estimating it; either way the value
    is snapped to the nearest ``NU_GRID`` point (0.01 resolution), where the
    lam moments were tabulated. Channels with fewer than ``_MIN_SAMPLES``
    informative rows warn and fall back (see ``_degenerate_gamma``).
    """
    diag: dict = {"source": "observed", "n_deployments": int(stats.n),
                  "n_mu": int(stats.mu_n)}

    if stats.mu_n >= _MIN_SAMPLES:
        mu_shape, mu_rate = _gamma_mle_from_moments(
            stats.mu_sum / stats.mu_n, stats.mu_logsum / stats.mu_n)
    else:
        mu_shape, mu_rate = _degenerate_gamma("mu", stats.mu_n, stats.mu_sum,
                                              diag)

    # sizes-minus-one are Poisson(sig) with m = 1 + n_scaleouts observations
    # (C0 counts); noise E Var[sig_hat|sig] = E[sig/m].
    if stats.sig_n >= _MIN_SAMPLES:
        sig_noise = (stats.sig_sum / stats.sig_n) * (stats.inv_m_sum
                                                     / stats.sig_n)
        sig_shape, sig_rate = _gamma_moments_from_sums(
            stats.sig_n, stats.sig_sum, stats.sig_sumsq, sig_noise)
    else:
        sig_shape, sig_rate = _degenerate_gamma("sig", stats.sig_n,
                                                stats.sig_sum, diag)

    nu_raw = _nu_from_bins(stats) if nu is None else float(nu)
    if not np.isfinite(nu_raw):
        nu_raw = 0.5
    gi = int(np.argmin(np.abs(NU_GRID - nu_raw)))
    nu_used = float(NU_GRID[gi])
    diag["nu_raw"] = float(nu_raw)

    # lam: N_i/(mu_hat**nu w_i) is conditionally unbiased for lam_i;
    # noise E Var = E[lam] * E[1/a].
    n_lam = float(stats.lam_n[gi])
    diag["n_lam"] = int(n_lam)
    if n_lam >= _MIN_SAMPLES:
        lam_noise = (stats.lam_sum[gi] / n_lam) * (stats.inv_a_sum[gi]
                                                   / n_lam)
        lam_shape, lam_rate = _gamma_moments_from_sums(
            n_lam, stats.lam_sum[gi], stats.lam_sumsq[gi], lam_noise)
    else:
        lam_shape, lam_rate = _degenerate_gamma("lam", n_lam,
                                                stats.lam_sum[gi], diag)

    delta = float(stats.spont_sum / max(stats.dwh_sum, 1e-12))

    fitted = PopulationPriors(
        mu_shape=mu_shape, mu_rate=mu_rate,
        lam_shape=lam_shape, lam_rate=lam_rate,
        sig_shape=sig_shape, sig_rate=sig_rate,
        delta=delta, nu=nu_used,
    )
    diag["nu"] = nu_used
    return fitted, diag


# ---------------------------------------------------------------------------
# The main entry point
# ---------------------------------------------------------------------------

def fit_priors(trace: WorkloadTrace, *, source: str = "auto",
               nu: float | None = None,
               nu_grid: np.ndarray | None = None,
               min_deaths: int = 2) -> tuple[PopulationPriors, dict]:
    """Fit ``PopulationPriors`` to a trace; returns (priors, diagnostics).

    ``source``: "latent" (requires latent columns), "observed" (uses only
    provider-visible observables), or "auto" (latent when available).
    ``nu`` fixes the power-law exponent instead of estimating it.
    ``nu_grid`` overrides the latent-path profile grid (the observed path
    always uses the module-level ``NU_GRID`` its lam moments are tabulated
    on).
    """
    if source == "auto":
        source = "latent" if has_latents(trace) else "observed"
    if source not in ("latent", "observed"):
        raise ValueError(f"unknown fit source {source!r}")

    if source == "observed":
        stats = window_stats(trace, 0.0, np.inf, min_deaths=min_deaths)
        fitted, diag = stats_to_priors(stats, nu=nu)
        log.debug(
            "fit_priors source=observed n=%d: mu=(%.4g,%.4g) lam=(%.4g,%.4g) "
            "sig=(%.4g,%.4g) delta=%.4g nu=%.3f", diag["n_deployments"],
            fitted.mu_shape, fitted.mu_rate, fitted.lam_shape,
            fitted.lam_rate, fitted.sig_shape, fitted.sig_rate,
            fitted.delta, fitted.nu)
        return fitted, diag

    if nu_grid is None:
        nu_grid = NU_GRID
    v = host(trace.valid)
    w = host(trace.obs_window).astype(np.float64)[v]
    n_so = host(trace.n_scaleouts).astype(np.float64)[v]
    spont = host(trace.spont_death)[v]
    diag = {"source": source, "n_deployments": int(v.sum())}

    lam = host(trace.lam).astype(np.float64)[v]
    mu = host(trace.mu).astype(np.float64)[v]
    sig = host(trace.sig).astype(np.float64)[v]
    mu_shape, mu_rate = fit_gamma_mle(mu)
    lam_shape, lam_rate = fit_gamma_mle(lam)
    sig_shape, sig_rate = fit_gamma_mle(sig)
    if nu is None:
        nu, nu_scores = _fit_nu_profile(n_so, lam, mu, w, nu_grid)
        diag["nu_scores"] = nu_scores
    delta = _fit_delta(spont, mu, w)

    fitted = PopulationPriors(
        mu_shape=mu_shape, mu_rate=mu_rate,
        lam_shape=lam_shape, lam_rate=lam_rate,
        sig_shape=sig_shape, sig_rate=sig_rate,
        delta=delta, nu=float(nu),
    )
    diag["nu"] = float(nu)
    log.debug(
        "fit_priors source=%s n=%d: mu=(%.4g,%.4g) lam=(%.4g,%.4g) "
        "sig=(%.4g,%.4g) delta=%.4g nu=%.3f", source,
        diag["n_deployments"], mu_shape, mu_rate, lam_shape, lam_rate,
        sig_shape, sig_rate, delta, nu)
    return fitted, diag


def prior_relative_errors(fitted: PopulationPriors,
                          reference: PopulationPriors) -> dict:
    """Per-field relative error |fit - ref| / |ref| (diagnostic/tests)."""
    return {f: abs(getattr(fitted, f) - getattr(reference, f))
            / max(abs(getattr(reference, f)), 1e-12)
            for f in PopulationPriors._fields}
