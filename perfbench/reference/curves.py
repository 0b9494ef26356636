"""Moment curves E[L_t], V[L_t] of a deployment's future size, in plain torch.

The closed forms of the paper's Props. 2, 3 and 5 as the admission system
defines them: L_t = M_t D_t (Q_t + B_t) under the provider's conjugate Gamma
belief, Q the surviving scale-out cores, B the surviving initial cores, M the
max-lifetime survival and D the probability of not having died from zero
cores, the factors uncorrelated. The D-term runs on ``nd`` uniform
checkpoints over (0, t_N] at mid-window lags and is interpolated linearly
onto the grid from the anchor (0, 1). The guards of the definition are kept:
Gamma continuation exponents held 1e-12 away from zero, survival
probabilities held below 1 - 1e-7.

Everything is computed in the dtype of the belief (float64 for the judge,
bfloat16 for the control); nothing here is shared with the program.
"""
from __future__ import annotations

import torch

EPS = 1e-12
P_MAX = 1.0 - 1e-7


def _away_from_zero(z):
    return torch.where(torch.abs(z) < EPS, torch.full_like(z, EPS), z)


def _product_var(ex, vx, ey, vy):
    """V[XY] of independent X, Y."""
    return vx * vy + vx * ey ** 2 + ex ** 2 * vy


def interpolation(grid: torch.Tensor, nd: int):
    """The D-term's checkpoint spacing w, and for each grid point the left
    checkpoint (0..nd-1, checkpoint 0 the anchor t = 0) and the weight of
    the right one."""
    w = grid[-1] / nd
    x = torch.arange(nd + 1, dtype=grid.dtype, device=grid.device) * w
    idx = torch.clamp(torch.searchsorted(x, grid, right=True) - 1, 0, nd - 1)
    frac = (grid - x[idx]) / w
    return w, idx, frac


def curves(bel, cores, grid, nu: float, delta: float, nd: int):
    """(EL, VL) [M, N] of M deployments: ``bel`` six [M] tensors (mu_a,
    mu_b, lam_a, lam_b, sig_a, sig_b), ``cores`` [M], ``grid`` [N], all of
    one dtype."""
    mu_a, mu_b, lam_a, lam_b, sig_a, sig_b = bel
    dt = mu_a.dtype
    a, b, c = mu_a[:, None], mu_b[:, None], cores.to(dt)[:, None]
    el = lam_a / lam_b
    el2 = lam_a * (lam_a + 1.0) / lam_b ** 2
    es = sig_a / sig_b
    es2 = sig_a * (sig_a + 1.0) / sig_b ** 2
    es1, es1_sq, ess2 = es + 1.0, es2 + 2.0 * es + 1.0, es2 + 2.0 * es
    eu, eu2 = el * es1, el2 * es1_sq
    z1 = _away_from_zero(mu_a + (nu - 1.0))
    rh1 = torch.exp(torch.lgamma(z1 + 1.0) - torch.lgamma(mu_a)
                    - (nu - 1.0) * torch.log(mu_b)) / z1
    z2 = _away_from_zero(mu_a + (2.0 * nu - 2.0))
    rk = torch.exp(torch.lgamma(z2 + 1.0) - torch.lgamma(mu_a)
                   - (2.0 * nu - 2.0) * torch.log(mu_b)) / z2
    e_mu_nu = torch.exp(torch.lgamma(mu_a + nu) - torch.lgamma(mu_a)
                        - nu * torch.log(mu_b))

    t = grid.to(dt)
    l1 = torch.log1p(t / b)
    l2 = torch.log1p(2.0 * t / b)
    # Q: scale-out cores still alive
    h1 = rh1[:, None] * -torch.expm1(-z1[:, None] * l1)
    h2 = rh1[:, None] * -torch.expm1(-z1[:, None] * l2)
    eq = eu[:, None] * h1
    evq = el[:, None] * (es1[:, None] * h1 + 0.5 * ess2[:, None] * h2)
    kk = rk[:, None] * (-2.0 * torch.expm1(-z2[:, None] * l1)
                        + torch.expm1(-z2[:, None] * l2))
    vq = evq + torch.clamp(eu2[:, None] * kk - eq ** 2, min=0.0)
    # B: initial cores still alive
    p1 = torch.exp(-a * l1)
    p2 = torch.exp(-a * l2)
    ebn = c * p1
    vb = c * (p1 - p2) + c ** 2 * torch.clamp(p2 - p1 ** 2, min=0.0)
    # M: max-lifetime survival
    em = torch.exp(-a * torch.log1p(delta * t / b))
    vm = em * (1.0 - em)
    # D: not dead from zero cores, at the checkpoints, then interpolated
    w, idx, frac = interpolation(t, nd)
    j = torch.arange(nd, dtype=dt, device=t.device)
    tau = w * (j + 0.5)
    tc = w * (j + 1.0)
    p_lag = torch.exp(-a * torch.log1p(tau / b))
    s = (eu * e_mu_nu * w)[:, None] * torch.log1p(-torch.clamp(p_lag,
                                                              max=P_MAX))
    p_self = torch.exp(-a * torch.log1p(tc / b))
    log_dead = (c * torch.log1p(-torch.clamp(p_self, max=P_MAX))
                + torch.cumsum(s, dim=-1))
    ed_sub = torch.cumprod(-torch.expm1(log_dead), dim=-1)
    ed_ext = torch.cat([torch.ones_like(ed_sub[:, :1]), ed_sub], dim=-1)
    ed = ed_ext[:, idx] * (1.0 - frac) + ed_ext[:, idx + 1] * frac
    vd = ed * (1.0 - ed)
    # L = M D (Q + B)
    er, vr = eq + ebn, vq + vb
    edr = ed * er
    vdr = _product_var(ed, vd, er, vr)
    return em * edr, _product_var(em, vm, edr, vdr)
