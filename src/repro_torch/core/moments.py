"""Closed-form moment curves E[L_t], V[L_t] of a deployment's future size.

The computational heart of the paper (Props. 2, 3, 5): under the provider's
Gamma belief (a,b)=(mu_a,mu_b), (al,bl)=(lam_a,lam_b), (as,bs)=(sig_a,sig_b)
for a deployment with C active cores, the future size is

    L_t = M_t * D_t * (Q_t + B_t)

with B_t = surviving initial cores, Q_t = surviving scale-out cores,
M_t = max-lifetime survival, D_t = "has not died from zero cores"; the
factors are treated as uncorrelated (the paper's stated approximation).

PyTorch counterpart of ``repro.core.moments``, holding its continuous-time
closed forms (``moment_curves``, the oracle), the packed fast path
(``pack_belief`` / ``moment_curves_fused``) and the cluster aggregate with
the JAX package's 512-slot block split and left fold over blocks
(``aggregate_moment_curves`` / ``masked_curve_reduction``).

Key Gamma integrals (mu ~ Gamma(a, b), rate parameterization):

    g(p, t) = E[mu^p e^(-t mu)]        = R(p) b^-p (1 + t/b)^-(a+p)
    H(p, t) = E[mu^p (1 - e^(-t mu))]  = R(p) b^-p (1 - (1+t/b)^-(a+p))
    K(p, t) = E[mu^p (1 - e^(-t mu))²] = R(p) b^-p (1 - 2(1+t/b)^-(a+p)
                                                      + (1+2t/b)^-(a+p))
    R(p)    = Gamma(a+p)/Gamma(a)

H and K are evaluated through ``exp(lgamma(a+p+1) - lgamma(a)) / (a+p)`` and
``expm1`` so the removable singularity at a+p = 0 never produces a NaN.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .belief import GammaBelief
from .processes import F32, PopulationPriors

_EPS = 1e-12


class MomentCurves(NamedTuple):
    """E and V of L over the horizon grid; shapes [..., N]."""

    EL: torch.Tensor
    VL: torch.Tensor


# ---------------------------------------------------------------------------
# Gamma-integral helpers. All take a, b with trailing broadcast vs t.
# ---------------------------------------------------------------------------

def _g(a, b, p, t):
    """E[mu^p e^(-t mu)]; requires a + p > 0 (true for p in {0, nu, 2nu})."""
    logr = torch.lgamma(a + p) - torch.lgamma(a)
    return torch.exp(logr - p * torch.log(b) - (a + p) * torch.log1p(t / b))


def _clamp_away_from_zero(z):
    return torch.where(torch.abs(z) < _EPS, _EPS, z)


def _h(a, b, p, t):
    """E[mu^p (1 - e^(-t mu))], valid for a + p > -1 (analytic continuation)."""
    z = _clamp_away_from_zero(a + p)
    logr1 = torch.lgamma(z + 1.0) - torch.lgamma(a)
    bracket = -torch.expm1(-z * torch.log1p(t / b))
    return torch.exp(logr1 - p * torch.log(b)) * bracket / z


def _k(a, b, p, t):
    """E[mu^p (1 - e^(-t mu))²], valid for a + p > -2."""
    z = _clamp_away_from_zero(a + p)
    logr1 = torch.lgamma(z + 1.0) - torch.lgamma(a)
    l1 = torch.log1p(t / b)
    l2 = torch.log1p(2.0 * t / b)
    bracket = -2.0 * torch.expm1(-z * l1) + torch.expm1(-z * l2)
    return torch.exp(logr1 - p * torch.log(b)) * bracket / z


def _sigma_moments(bel: GammaBelief):
    """E[sigma+1], E[(sigma+1)^2], E[sigma(sigma+2)] under Gamma(as, bs)."""
    es = bel.sig_a / bel.sig_b
    es2 = bel.sig_a * (bel.sig_a + 1.0) / bel.sig_b**2
    e_s1 = es + 1.0
    e_s1_sq = es2 + 2.0 * es + 1.0
    e_ss2 = es2 + 2.0 * es
    return e_s1, e_s1_sq, e_ss2


def _lam_moments(bel: GammaBelief):
    el = bel.lam_a / bel.lam_b
    el2 = bel.lam_a * (bel.lam_a + 1.0) / bel.lam_b**2
    return el, el2


def _product_var(ex, vx, ey, vy):
    """V[XY] for independent X, Y."""
    return vx * vy + vx * ey**2 + ex**2 * vy


# ---------------------------------------------------------------------------
# D-term: probability the deployment has not hit zero cores (paper Prop. 2),
# on a uniform checkpoint grid where the inner product over past windows is
# one cumulative sum over lags.
# ---------------------------------------------------------------------------

def _d_curve_uniform(a, b, eu, e_mu_nu, cores, w, nd: int, *,
                     midpoint: bool):
    """E[D] at uniform checkpoints t_j = w*j, j=1..nd. Leading dims broadcast.

    midpoint=False reproduces the paper exactly (windows i < j, elapsed
    (j-i)*w); midpoint=True also counts the current window at half-window
    elapsed time (the variant the continuous path uses).
    """
    q = eu * e_mu_nu  # expected cores added per hour
    w = torch.as_tensor(w, dtype=F32, device=a.device)
    lags = torch.arange(nd, dtype=F32, device=a.device)
    tau = w * (lags + 0.5) if midpoint else w * (lags + 1.0)
    p_lag = torch.exp(-a[..., None] * torch.log1p(tau / b[..., None]))
    s = (q * w)[..., None] * torch.log1p(-torch.clamp(p_lag, max=1.0 - 1e-7))
    cums = torch.cumsum(s, dim=-1)
    if midpoint:
        window_sum = cums                      # lags 0..j-1
    else:
        window_sum = torch.cat(                # lags 1..j-1
            [torch.zeros_like(cums[..., :1]), cums[..., :-1]], dim=-1)
    tc = w * torch.arange(1, nd + 1, dtype=F32, device=a.device)
    p_self = torch.exp(-a[..., None] * torch.log1p(tc / b[..., None]))
    log_dead = (cores[..., None]
                * torch.log1p(-torch.clamp(p_self, max=1.0 - 1e-7))
                + window_sum)
    factor = -torch.expm1(log_dead)  # 1 - Pr(all cores dead at t_j)
    return torch.cumprod(factor, dim=-1)


def _interp_rows(t_full, ts, ys):
    """Piecewise-linear interp of per-slot curves ys [..., Nd] from grid ts
    [Nd] (with implicit (0, 1) left anchor) onto t_full [N]; the same
    arithmetic as ``jnp.interp`` row by row."""
    xp = torch.cat([torch.zeros(1, dtype=ts.dtype, device=ts.device), ts])
    fp = torch.cat([torch.ones(ys.shape[:-1] + (1,), dtype=ys.dtype,
                               device=ys.device), ys], dim=-1)
    i = torch.clamp(torch.searchsorted(xp, t_full, right=True), 1,
                    xp.shape[0] - 1)
    lo, hi = fp[..., i - 1], fp[..., i]
    dx = xp[i] - xp[i - 1]
    delta = t_full - xp[i - 1]
    f = lo + (delta / dx) * (hi - lo)
    f = torch.where(t_full < xp[0], fp[..., :1], f)
    return torch.where(t_full > xp[-1], fp[..., -1:], f)


# ---------------------------------------------------------------------------
# Continuous-time closed forms (the oracle).
# ---------------------------------------------------------------------------

def moment_curves(bel: GammaBelief, cores: torch.Tensor,
                  t_grid: torch.Tensor, priors: PopulationPriors, *,
                  d_points: int = 32) -> MomentCurves:
    """E[L_t], V[L_t] at horizon times ``t_grid`` [N] (hours from now).

    ``bel`` fields and ``cores`` share a batch shape [...]; output [..., N].
    The D-term runs on ``d_points`` uniform checkpoints spanning
    (0, max(t_grid)] and is linearly interpolated onto ``t_grid``.
    """
    nu = priors.nu
    a, b = bel.mu_a[..., None], bel.mu_b[..., None]
    el, el2 = _lam_moments(bel)
    e_s1, e_s1_sq, e_ss2 = _sigma_moments(bel)
    eu = el * e_s1
    eu2 = el2 * e_s1_sq
    t = t_grid
    c = cores[..., None].to(t_grid.dtype)

    # --- Q: scale-out cores still alive -----------------------------------
    h1 = _h(a, b, nu - 1.0, t)
    eq = eu[..., None] * h1
    evq = el[..., None] * (e_s1[..., None] * h1
                           + 0.5 * e_ss2[..., None] * _h(a, b, nu - 1.0,
                                                         2.0 * t))
    veq = eu2[..., None] * _k(a, b, 2.0 * nu - 2.0, t) - eq**2
    vq = evq + torch.clamp(veq, min=0.0)

    # --- B: initial cores still alive --------------------------------------
    p1 = _g(a, b, 0.0, t)
    p2 = _g(a, b, 0.0, 2.0 * t)
    ebn = c * p1
    vb = c * (p1 - p2) + c**2 * torch.clamp(p2 - p1**2, min=0.0)

    # --- M: max-lifetime survival ------------------------------------------
    em = torch.exp(-a * torch.log1p(priors.delta * t / b))
    vm = em * (1.0 - em)

    # --- D: zero-core death ------------------------------------------------
    e_mu_nu = bel.expected_mu_pow(nu)
    w = t_grid[-1] / d_points
    ed_sub = _d_curve_uniform(bel.mu_a, bel.mu_b, eu, e_mu_nu,
                              cores.to(t_grid.dtype), w, d_points,
                              midpoint=True)
    tc = w * torch.arange(1, d_points + 1, dtype=F32, device=t_grid.device)
    ed = _interp_rows(t_grid, tc, ed_sub)
    vd = ed * (1.0 - ed)

    # --- compose L = M * D * (Q + B) ---------------------------------------
    er = eq + ebn
    vr = vq + vb
    edr = ed * er
    vdr = _product_var(ed, vd, er, vr)
    return MomentCurves(EL=em * edr, VL=_product_var(em, vm, edr, vdr))


# ---------------------------------------------------------------------------
# Packed fast path: per-slot Gamma-continuation factors are packed once (the
# lgamma-heavy part, shared with the kernels' packing in
# kernels/moment_curves/ops.py); curves are then evaluated with shared log1p
# subexpressions and the D-term interpolated by two-point weights.
# ---------------------------------------------------------------------------

class PackedBelief(NamedTuple):
    """Per-slot scalar factors of the moment-curve closed forms."""

    a: torch.Tensor        # mu posterior shape
    b: torch.Tensor        # mu posterior rate
    cores: torch.Tensor    # current active cores C
    eu: torch.Tensor       # E[lam] E[sig+1]
    eu2: torch.Tensor      # E[lam^2] E[(sig+1)^2]
    el: torch.Tensor       # E[lam]
    es1: torch.Tensor      # E[sig+1]
    ess2: torch.Tensor     # E[sig(sig+2)]
    rh1: torch.Tensor      # H-integral continuation factor at p = nu-1
    z1: torch.Tensor       # a + nu - 1 (clamped away from 0)
    rk: torch.Tensor       # K-integral continuation factor at p = 2nu-2
    z2: torch.Tensor       # a + 2nu - 2 (clamped away from 0)
    e_mu_nu: torch.Tensor  # E[mu^nu]


def pack_belief(bel: GammaBelief, cores: torch.Tensor,
                priors: PopulationPriors) -> PackedBelief:
    """Precompute the per-slot factors; shapes follow ``bel`` fields."""
    nu = priors.nu
    a, b = bel.mu_a, bel.mu_b
    el, el2 = _lam_moments(bel)
    e_s1, e_s1_sq, e_ss2 = _sigma_moments(bel)

    z1 = _clamp_away_from_zero(a + nu - 1.0)
    rh1 = torch.exp(torch.lgamma(z1 + 1.0) - torch.lgamma(a)
                    - (nu - 1.0) * torch.log(b)) / z1
    z2 = _clamp_away_from_zero(a + 2.0 * nu - 2.0)
    rk = torch.exp(torch.lgamma(z2 + 1.0) - torch.lgamma(a)
                   - (2.0 * nu - 2.0) * torch.log(b)) / z2
    e_mu_nu = torch.exp(torch.lgamma(a + nu) - torch.lgamma(a)
                        - nu * torch.log(b))
    return PackedBelief(
        a=a, b=b, cores=cores.to(a.dtype), eu=el * e_s1,
        eu2=el2 * e_s1_sq, el=el, es1=e_s1, ess2=e_ss2, rh1=rh1, z1=z1,
        rk=rk, z2=z2, e_mu_nu=e_mu_nu,
    )


def interp_points(t_grid: torch.Tensor, nd: int):
    """The D-term's uniform checkpoints and the two-point interpolation onto
    ``t_grid`` [N]: returns (x [ND+1] checkpoint times with the t=0 anchor,
    idx [N] int32 left checkpoint, frac [N] weight of the right one)."""
    w = t_grid[-1] / nd
    x = torch.arange(nd + 1, dtype=F32, device=t_grid.device) * w
    idx = torch.clamp(torch.searchsorted(x, t_grid, right=True) - 1, 0,
                      nd - 1)
    frac = (t_grid - x[idx]) / w
    return x, idx.to(torch.int32), frac


def interp_matrix(t_grid: torch.Tensor, nd: int):
    """D-term checkpoint grids + linear-interp weights as one matrix.

    Returns (tc [ND] checkpoint times, tau [ND] midpoint lags,
    w_mat [ND+1, N] hat-function weights with the implicit (0, 1) anchor in
    row 0) such that ``ed_ext @ w_mat == interp(t_grid)``.
    """
    x, idx, frac = interp_points(t_grid, nd)
    idx = idx.long()
    rows = torch.arange(nd + 1, device=t_grid.device)[:, None]
    w_mat = ((rows == idx[None, :]).to(F32) * (1.0 - frac)[None, :]
             + (rows == idx[None, :] + 1).to(F32) * frac[None, :])
    w = t_grid[-1] / nd
    tau = w * (torch.arange(nd, dtype=F32, device=t_grid.device) + 0.5)
    return x[1:], tau, w_mat


def _curves_from_packed(p: PackedBelief, t_grid: torch.Tensor,
                        w_mat: torch.Tensor, priors: PopulationPriors,
                        nd: int) -> MomentCurves:
    """Curves [..., N] from packed factors; log1p(t/b) / log1p(2t/b) shared
    across the Q/B/M factors, D-term interpolated via one matmul."""
    t = t_grid
    a, b, c = p.a[..., None], p.b[..., None], p.cores[..., None]
    l1 = torch.log1p(t / b)
    l2 = torch.log1p(2.0 * t / b)

    h1 = p.rh1[..., None] * -torch.expm1(-p.z1[..., None] * l1)
    h2 = p.rh1[..., None] * -torch.expm1(-p.z1[..., None] * l2)
    eq = p.eu[..., None] * h1
    evq = p.el[..., None] * (p.es1[..., None] * h1
                             + 0.5 * p.ess2[..., None] * h2)
    kk = p.rk[..., None] * (-2.0 * torch.expm1(-p.z2[..., None] * l1)
                            + torch.expm1(-p.z2[..., None] * l2))
    veq = p.eu2[..., None] * kk - eq**2
    vq = evq + torch.clamp(veq, min=0.0)

    p1 = torch.exp(-a * l1)
    p2 = torch.exp(-a * l2)
    ebn = c * p1
    vb = c * (p1 - p2) + c**2 * torch.clamp(p2 - p1**2, min=0.0)
    em = torch.exp(-a * torch.log1p(priors.delta * t / b))
    vm = em * (1.0 - em)

    w = t_grid[-1] / nd
    ed_sub = _d_curve_uniform(p.a, p.b, p.eu, p.e_mu_nu, p.cores, w, nd,
                              midpoint=True)
    ones = torch.ones(ed_sub.shape[:-1] + (1,), dtype=F32,
                      device=ed_sub.device)
    ed = torch.cat([ones, ed_sub], dim=-1) @ w_mat
    vd = ed * (1.0 - ed)

    er = eq + ebn
    vr = vq + vb
    edr = ed * er
    vdr = _product_var(ed, vd, er, vr)
    return MomentCurves(EL=em * edr, VL=_product_var(em, vm, edr, vdr))


def moment_curves_fused(bel: GammaBelief, cores: torch.Tensor,
                        t_grid: torch.Tensor, priors: PopulationPriors, *,
                        d_points: int = 32) -> MomentCurves:
    """Per-slot curves via the packed fast path — same closed forms and
    midpoint D-term as ``moment_curves``; only subexpression sharing and the
    matrix interpolation differ (agreement to ~1e-6 relative)."""
    packed = pack_belief(bel, cores, priors)
    _, _, w_mat = interp_matrix(t_grid.to(F32), d_points)
    return _curves_from_packed(packed, t_grid, w_mat, priors, d_points)


def _masked_sum(curves: MomentCurves, mask: torch.Tensor) -> MomentCurves:
    return MomentCurves(EL=torch.einsum("sn,s->n", curves.EL, mask),
                        VL=torch.einsum("sn,s->n", curves.VL, mask))


def aggregate_moment_curves(bel: GammaBelief, cores: torch.Tensor,
                            alive: torch.Tensor, t_grid: torch.Tensor,
                            priors: PopulationPriors, *, d_points: int = 32,
                            block_size: int = 512) -> MomentCurves:
    """Cluster-wide (sum over alive slots) E[L_t] and V[L_t], shapes [N].

    Dead slots are masked inside the block reduction; the full [S, N] curve
    matrix is never materialized beyond one block. Up to ``block_size`` slots
    this is one masked sum; beyond, filler slots pad S to a block multiple
    and the blocks are folded left to right, as the JAX package does.
    """
    s = cores.shape[-1]
    packed = pack_belief(bel, cores, priors)
    mask = alive.to(t_grid.dtype)
    _, _, w_mat = interp_matrix(t_grid.to(F32), d_points)

    if s <= block_size:
        return _masked_sum(
            _curves_from_packed(packed, t_grid, w_mat, priors, d_points),
            mask)

    pad = (-s) % block_size
    if pad:
        # filler slots: benign parameters, masked out of the reduction
        packed = PackedBelief(*(torch.cat([x, torch.ones(pad, dtype=x.dtype,
                                                         device=x.device)])
                                for x in packed))
        mask = torch.cat([mask, torch.zeros(pad, dtype=mask.dtype,
                                            device=mask.device)])
    n = t_grid.shape[-1]
    el_acc = torch.zeros(n, dtype=t_grid.dtype, device=t_grid.device)
    vl_acc = torch.zeros_like(el_acc)
    for lo in range(0, s + pad, block_size):
        blk = PackedBelief(*(x[lo:lo + block_size] for x in packed))
        part = _masked_sum(
            _curves_from_packed(blk, t_grid, w_mat, priors, d_points),
            mask[lo:lo + block_size])
        el_acc = el_acc + part.EL
        vl_acc = vl_acc + part.VL
    return MomentCurves(EL=el_acc, VL=vl_acc)


def masked_curve_reduction(curves: MomentCurves, mask: torch.Tensor,
                           block_size: int = 512) -> MomentCurves:
    """Reduce already-evaluated per-slot curves ``[S, N]`` to the masked
    cluster aggregate ``[N]`` with the reduction structure of
    ``aggregate_moment_curves``: one masked sum up to ``block_size`` slots, a
    left fold of per-block sums beyond (zero filler rows pad the last
    block)."""
    s = mask.shape[-1]
    if s <= block_size:
        return _masked_sum(curves, mask)
    pad = (-s) % block_size
    if pad:
        curves = MomentCurves(*(
            torch.cat([x, torch.zeros(pad, x.shape[-1], dtype=x.dtype,
                                      device=x.device)]) for x in curves))
        mask = torch.cat([mask, torch.zeros(pad, dtype=mask.dtype,
                                            device=mask.device)])
    n = curves.EL.shape[-1]
    el_acc = torch.zeros(n, dtype=curves.EL.dtype, device=mask.device)
    vl_acc = torch.zeros_like(el_acc)
    for lo in range(0, s + pad, block_size):
        part = _masked_sum(
            MomentCurves(*(x[lo:lo + block_size] for x in curves)),
            mask[lo:lo + block_size])
        el_acc = el_acc + part.EL
        vl_acc = vl_acc + part.VL
    return MomentCurves(EL=el_acc, VL=vl_acc)


# ---------------------------------------------------------------------------
# Paper-discrete forms (Prop. 5) on the uniform step grid.
# ---------------------------------------------------------------------------

def moment_curves_discrete(bel: GammaBelief, cores: torch.Tensor,
                           n_steps: int, dt: float,
                           priors: PopulationPriors) -> MomentCurves:
    """Uniform-grid curves at t = dt*(1..n_steps), per the paper's Prop. 5.

    Scale-outs are Poisson *per step* (count ~ Pois(lam mu^nu dt)); a core
    added in step i survives to step n w.p. e^(-(n-i) dt mu). All n are
    evaluated at once with prefix sums (O(N) in all, not the paper's O(N²)).
    """
    nu = priors.nu
    device = bel.mu_a.device
    a, b = bel.mu_a[..., None], bel.mu_b[..., None]
    el, el2 = _lam_moments(bel)
    e_s1, e_s1_sq, e_ss2 = _sigma_moments(bel)
    eu, eu2 = el * e_s1, el2 * e_s1_sq

    n = n_steps
    d = torch.arange(n, dtype=F32, device=device)   # elapsed steps 0..n-1
    s = torch.arange(2 * n - 1, dtype=F32, device=device)
    g1 = _g(a, b, nu, d * dt)                        # [..., n]
    g2 = _g(a, b, nu, 2.0 * d * dt)
    g3 = _g(a, b, 2.0 * nu, s * dt)                  # [..., 2n-1]

    cs1 = torch.cumsum(g1, dim=-1)                   # sum_{d=0}^{m} g1
    cs2 = torch.cumsum(g2, dim=-1)
    a3 = torch.cumsum(g3, dim=-1)
    b3 = torch.cumsum(s * g3, dim=-1)

    nn = torch.arange(1, n + 1, dtype=F32, device=device)
    eq = eu[..., None] * dt * cs1
    evq = el[..., None] * dt * (e_s1[..., None] * cs1
                                + e_ss2[..., None] * cs2)
    # E[W_n^2] = sum_{s=0}^{2n-2} min(s+1, 2n-1-s) g3(s)
    a_n, b_n = a3[..., :n], b3[..., :n]               # index n-1
    a_2n, b_2n = a3[..., ::2], b3[..., ::2]           # index 2n-2
    ew2 = (b_n + a_n) + ((2.0 * nn - 1.0) * (a_2n - a_n) - (b_2n - b_n))
    veq = eu2[..., None] * dt**2 * ew2 - (eu[..., None] * dt * cs1) ** 2
    vq = evq + torch.clamp(veq, min=0.0)

    t = nn * dt
    c = cores[..., None].to(F32)
    p1 = _g(a, b, 0.0, t)
    p2 = _g(a, b, 0.0, 2.0 * t)
    ebn = c * p1
    vb = c * (p1 - p2) + c**2 * torch.clamp(p2 - p1**2, min=0.0)
    em = torch.exp(-a * torch.log1p(priors.delta * t / b))
    vm = em * (1.0 - em)

    # the paper's D recursion on the uniform step grid (lag cumsum, O(N))
    ed = _d_curve_uniform(bel.mu_a, bel.mu_b, eu, bel.expected_mu_pow(nu),
                          cores.to(F32), dt, n, midpoint=False)
    vd = ed * (1.0 - ed)

    er = eq + ebn
    vr = vq + vb
    edr = ed * er
    vdr = _product_var(ed, vd, er, vr)
    return MomentCurves(EL=em * edr, VL=_product_var(em, vm, edr, vdr))


def moment_curves_discrete_naive(bel_np, cores, n_steps: int, dt: float,
                                 priors: PopulationPriors) -> MomentCurves:
    """Direct O(N²) float64 numpy transcription of the discrete sums: the
    test oracle. ``bel_np``: a GammaBelief of scalar floats; ``cores``: a
    scalar. Returns numpy arrays [n_steps]."""
    from math import lgamma

    import numpy as np

    a, b = float(bel_np.mu_a), float(bel_np.mu_b)
    al, bl = float(bel_np.lam_a), float(bel_np.lam_b)
    asg, bsg = float(bel_np.sig_a), float(bel_np.sig_b)
    nu, delta = priors.nu, priors.delta

    def g(p, tau):
        return np.exp(lgamma(a + p) - lgamma(a) - p * np.log(b)
                      - (a + p) * np.log1p(tau / b))

    el = al / bl
    el2 = al * (al + 1) / bl**2
    es = asg / bsg
    es2 = asg * (asg + 1) / bsg**2
    e_s1, e_s1_sq, e_ss2 = es + 1, es2 + 2 * es + 1, es2 + 2 * es
    eu, eu2 = el * e_s1, el2 * e_s1_sq
    e_mu_nu = g(nu, 0.0)

    n_arr = np.arange(1, n_steps + 1)
    eq, vq = np.zeros(n_steps), np.zeros(n_steps)
    ebv, vb = np.zeros(n_steps), np.zeros(n_steps)
    em, ed = np.zeros(n_steps), np.zeros(n_steps)
    for ni, n in enumerate(n_arr):
        ew = sum(g(nu, (n - i) * dt) for i in range(1, n + 1))
        eq[ni] = eu * dt * ew
        evq = el * dt * sum(
            e_s1 * g(nu, (n - i) * dt) + e_ss2 * g(nu, 2 * (n - i) * dt)
            for i in range(1, n + 1))
        ew2 = sum(g(2 * nu, (2 * n - i - j) * dt)
                  for i in range(1, n + 1) for j in range(1, n + 1))
        veq = eu2 * dt**2 * ew2 - (eu * dt * ew) ** 2
        vq[ni] = evq + max(veq, 0.0)
        t = n * dt
        p1, p2 = g(0.0, t), g(0.0, 2 * t)
        ebv[ni] = cores * p1
        vb[ni] = cores * (p1 - p2) + cores**2 * max(p2 - p1**2, 0.0)
        em[ni] = np.exp(-a * np.log1p(delta * t / b))

    # the D recursion, paper (16)-(17), on the uniform grid
    ed_prev = 1.0
    q_step = eu * e_mu_nu * dt
    for ni, n in enumerate(n_arr):
        p_self = g(0.0, n * dt)
        log_dead = cores * np.log1p(-min(p_self, 1 - 1e-7))
        for i in range(1, n):
            pij = g(0.0, (n - i) * dt)
            log_dead += q_step * np.log1p(-min(pij, 1 - 1e-7))
        ed[ni] = (ed_prev if ni else 1.0) * -np.expm1(log_dead)
        ed_prev = ed[ni]

    vm = em * (1 - em)
    vd = ed * (1 - ed)
    er, vr = eq + ebv, vq + vb
    edr = ed * er
    vdr = vd * vr + vd * er**2 + ed**2 * vr
    elc = em * edr
    vl = vm * vdr + vm * edr**2 + em**2 * vdr
    return MomentCurves(EL=elc, VL=vl)
