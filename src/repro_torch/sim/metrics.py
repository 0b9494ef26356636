"""Run metrics: utilization aggregation, SLA accounting, BCa bootstrap CIs.

The paper reports 95% bias-corrected and accelerated (BCa) bootstrap
confidence intervals (Efron 1987) because importance sampling biases naive
standard errors. ``bca_ci`` implements BCa for (optionally weighted) run-level
statistics.

The port's own copy of ``repro.sim.metrics`` (numpy and scipy only: the
port imports nothing of the JAX package); the tests hold its ``bca_ci`` to
the reference's on the same input.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
from scipy.special import ndtr, ndtri


class CI(NamedTuple):
    estimate: float
    lo: float
    hi: float

    def __str__(self) -> str:  # pragma: no cover - display helper
        return f"{self.estimate:.4f} ({self.lo:.4f}, {self.hi:.4f})"


def weighted_mean(values: np.ndarray, weights: Optional[np.ndarray] = None) -> float:
    values = np.asarray(values, dtype=np.float64)
    if weights is None:
        return float(values.mean())
    w = np.asarray(weights, dtype=np.float64)
    return float(np.sum(w * values) / np.sum(w))


def bca_ci(
    values: np.ndarray,
    weights: Optional[np.ndarray] = None,
    stat: Callable[[np.ndarray, Optional[np.ndarray]], float] = weighted_mean,
    n_resamples: int = 10_000,
    alpha: float = 0.05,
    seed: int = 0,
) -> CI:
    """BCa bootstrap CI of ``stat`` over run-level ``values`` (Efron 1987).

    Importance-sampling ``weights`` ride along with their runs during
    resampling (resample runs uniformly, recompute the weighted statistic),
    which is the standard weighted-bootstrap treatment.

    The ``n_resamples`` bootstrap loop is vectorized for the default
    ``weighted_mean`` statistic — one ``[n_resamples, n]`` gather and a
    row reduction instead of ``n_resamples`` python calls (same resample
    index matrix, same float64 row arithmetic, so the returned CI is
    identical to the loop's at a fixed seed). A custom ``stat`` keeps the
    general one-call-per-resample path.
    """
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    rng = np.random.default_rng(seed)
    theta_hat = stat(values, weights)

    idx = rng.integers(0, n, size=(n_resamples, n))
    if stat is weighted_mean:
        if weights is None:
            boot = values[idx].mean(axis=1)
        else:
            w = np.asarray(weights, dtype=np.float64)[idx]
            boot = np.sum(w * values[idx], axis=1) / np.sum(w, axis=1)
    else:
        boot = np.empty(n_resamples)
        for i in range(n_resamples):
            sel = idx[i]
            boot[i] = stat(values[sel],
                           None if weights is None else weights[sel])

    # bias correction
    prop = np.mean(boot < theta_hat)
    prop = min(max(prop, 1.0 / n_resamples), 1.0 - 1.0 / n_resamples)
    z0 = ndtri(prop)

    # acceleration via jackknife
    jack = np.empty(n)
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        mask[i] = False
        jack[i] = stat(values[mask], None if weights is None else weights[mask])
        mask[i] = True
    jm = jack.mean()
    num = np.sum((jm - jack) ** 3)
    den = 6.0 * np.sum((jm - jack) ** 2) ** 1.5
    a = num / den if den > 0 else 0.0

    z_lo, z_hi = ndtri(alpha / 2.0), ndtri(1.0 - alpha / 2.0)
    p_lo = ndtr(z0 + (z0 + z_lo) / (1.0 - a * (z0 + z_lo)))
    p_hi = ndtr(z0 + (z0 + z_hi) / (1.0 - a * (z0 + z_hi)))
    lo, hi = np.quantile(boot, [p_lo, p_hi])
    return CI(estimate=float(theta_hat), lo=float(lo), hi=float(hi))


def fleet_utilization(util_clusters: np.ndarray,
                      capacities: np.ndarray) -> np.ndarray:
    """Fleet utilization from per-cluster utilizations: the capacity-weighted
    mean over the trailing cluster axis (equals total core-hours over total
    capacity-hours, which is what ``FleetMetrics.utilization`` reports)."""
    u = np.asarray(util_clusters, dtype=np.float64)
    c = np.asarray(capacities, dtype=np.float64)
    return np.sum(u * c, axis=-1) / np.sum(c)


def fleet_sla_failure_rate(failed_clusters: np.ndarray,
                           requests_clusters: np.ndarray,
                           weights: Optional[np.ndarray] = None) -> float:
    """Aggregate fleet SLA failure rate from per-cluster run totals.

    ``failed_clusters``/``requests_clusters`` carry a trailing cluster axis
    (leading axes are runs); counts are summed over clusters first — the
    fleet SLA is one constraint over the whole fleet's requests, not a mean
    of per-cluster rates — then aggregated over runs exactly like
    ``sla_failure_rate`` (optionally importance-weighted).
    """
    f = np.asarray(failed_clusters, dtype=np.float64).sum(axis=-1)
    r = np.asarray(requests_clusters, dtype=np.float64).sum(axis=-1)
    return sla_failure_rate(f, r, weights=weights)


def sla_failure_rate(total_failed: np.ndarray, total_requests: np.ndarray,
                     weights: Optional[np.ndarray] = None) -> float:
    """Aggregate SLA failure fraction over runs (failures are concentrated in
    tail runs, so aggregate counts — not per-run rates — are averaged, as in
    the paper's 'satisfied on average' check)."""
    f = np.asarray(total_failed, dtype=np.float64)
    r = np.asarray(total_requests, dtype=np.float64)
    if weights is None:
        weights = np.ones_like(f)
    w = np.asarray(weights, dtype=np.float64)
    return float(np.sum(w * f) / max(np.sum(w * r), 1.0))
