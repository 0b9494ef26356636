"""Plain PyTorch versions of the two moment-curve CUDA kernels.

Same calling convention as the launchers in ``kernel.py``: packed rows
``params [D, 16]`` (column layout below), the horizon grid ``t [N]``, and the
D-term's two-point interpolation ``idx [N]`` int32 / ``frac [N]`` f32 from
``core.moments.interp_points``; the checkpoint spacing is ``t[-1] / nd``.
The lag cumsum and the cumprod run with ``torch.cumsum`` /
``torch.cumprod``. ``ops.py`` takes these on CPU tensors, and the card's
smoke test holds each kernel against them; the main path on the card never
calls them.
"""
from __future__ import annotations

import torch

# packed parameter columns (ALIVE is consumed only by the aggregate variant)
(A, B, C0, EU, EU2, EL_, ES1, ESS2, RH1, Z1, RK, Z2, EMUNU, DELTA, ALIVE,
 _PAD) = range(16)
N_COLS = 16

_P_MAX = 1.0 - 1e-7     # clamp of the per-lag survival before log1p(-p)
_FACTOR_MIN = 1e-37     # clamp of the D-term factor, as in the TPU kernel


def _curve_rows(params: torch.Tensor, t: torch.Tensor, idx: torch.Tensor,
                frac: torch.Tensor, nd: int):
    """EL, VL [D, N] for packed rows ``params`` [D, 16]."""
    col = lambda i: params[:, i:i + 1]                   # [D, 1]
    a, b, c = col(A), col(B), col(C0)
    eu, eu2, el, es1, ess2 = col(EU), col(EU2), col(EL_), col(ES1), col(ESS2)
    rh1, z1, rk, z2 = col(RH1), col(Z1), col(RK), col(Z2)
    e_mu_nu, delta = col(EMUNU), col(DELTA)

    t = t[None, :]                                       # [1, N]
    l1 = torch.log1p(t / b)
    l2 = torch.log1p(2.0 * t / b)
    h1 = rh1 * -torch.expm1(-z1 * l1)
    h2 = rh1 * -torch.expm1(-z1 * l2)
    eq = eu * h1
    evq = el * (es1 * h1 + 0.5 * ess2 * h2)
    kk = rk * (-2.0 * torch.expm1(-z2 * l1) + torch.expm1(-z2 * l2))
    vq = evq + torch.clamp(eu2 * kk - eq * eq, min=0.0)

    p1 = torch.exp(-a * l1)
    p2 = torch.exp(-a * l2)
    eb = c * p1
    vb = c * (p1 - p2) + c * c * torch.clamp(p2 - p1 * p1, min=0.0)
    em = torch.exp(-a * torch.log1p(delta * t / b))
    vm = em * (1.0 - em)

    # --- D-term on uniform checkpoints ------------------------------------
    w = t[0, -1] / nd
    j = torch.arange(nd, dtype=torch.float32, device=params.device)
    tau = w * (j + 0.5)                                  # midpoint lags
    tc = (j + 1.0) * w                                   # checkpoints
    p_lag = torch.exp(-a * torch.log1p(tau / b))
    s = (eu * e_mu_nu * w) * torch.log1p(-torch.clamp(p_lag, max=_P_MAX))
    p_self = torch.exp(-a * torch.log1p(tc / b))
    log_dead = (c * torch.log1p(-torch.clamp(p_self, max=_P_MAX))
                + torch.cumsum(s, dim=1))
    factor = torch.clamp(-torch.expm1(log_dead), min=_FACTOR_MIN)
    ed_sub = torch.cumprod(factor, dim=1)                # [D, ND]
    ed_ext = torch.cat([torch.ones_like(ed_sub[:, :1]), ed_sub], dim=1)
    i = idx.long()
    ed = ed_ext[:, i] * (1.0 - frac) + ed_ext[:, i + 1] * frac
    vd = ed * (1.0 - ed)

    er = eq + eb
    vr = vq + vb
    edr = ed * er
    vdr = vd * vr + vd * er * er + ed * ed * vr
    return em * edr, vm * vdr + vm * edr * edr + em * em * vdr


def moment_curves_packed_ref(params: torch.Tensor, t: torch.Tensor,
                             idx: torch.Tensor, frac: torch.Tensor,
                             nd: int):
    """Per-row curves: (EL, VL), each [D, N]."""
    return _curve_rows(params, t, idx, frac, nd)


def moment_curves_agg_packed_ref(params: torch.Tensor, t: torch.Tensor,
                                 idx: torch.Tensor, frac: torch.Tensor,
                                 nd: int):
    """Sum over rows weighted by the ALIVE column: (EL, VL), each [N]."""
    el, vl = _curve_rows(params, t, idx, frac, nd)
    mask = params[:, ALIVE]
    return mask @ el, mask @ vl
