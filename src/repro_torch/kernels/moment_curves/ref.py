"""Plain PyTorch versions of the moment-curve CUDA kernels.

Packed form, the launchers' ``moment_curves_packed`` /
``moment_curves_agg_packed``: packed rows ``params [D, 16]`` (column layout
below), the horizon grid ``t [N]``, and the D-term's two-point interpolation
``idx [N]`` int32 / ``frac [N]`` f32 from ``core.moments.interp_points``;
the checkpoint spacing is ``t[-1] / nd``. The lag cumsum and the cumprod
run with ``torch.cumsum`` / ``torch.cumprod``.

Belief form, the launchers' ``moment_curves_belief`` /
``moment_curves_agg_belief``: the slot table's ``GammaBelief`` columns,
``cores`` and (aggregate) the bool ``alive`` column, packed here by
``core.moments.pack_belief`` and then evaluated by the packed versions.
Given R runs' tables (columns [R, D]), the aggregate is the one-run
version's, run by run.

The launchers take these on CPU tensors, and the card's smoke test holds
each kernel against them; the main path on the card never calls them.
``pack_in_kernel_order`` and ``agg_in_kernel_order`` (``_runs``: for each
run of a batch) repeat on the CPU, step for step, the belief kernel's
in-register pack and the aggregate kernel's order of summation, for the
tests.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ...core.belief import GammaBelief
from ...core.moments import _clamp_away_from_zero, pack_belief
from ...core.processes import F32, PopulationPriors

# packed parameter columns (ALIVE is consumed only by the aggregate variant)
(A, B, C0, EU, EU2, EL_, ES1, ESS2, RH1, Z1, RK, Z2, EMUNU, DELTA, ALIVE,
 _PAD) = range(16)
N_COLS = 16

_P_MAX = 1.0 - 1e-7     # clamp of the per-lag survival before log1p(-p)
_FACTOR_MIN = 1e-37     # clamp of the D-term factor, as in the TPU kernel

# the aggregate kernel's geometry (csrc/moment_curves.cu): warps a CTA, two
# rows a warp
AGG_WARPS = 32
AGG_ROWS_PER_CTA = 2 * AGG_WARPS


class PackConstants(NamedTuple):
    """The belief kernel's scalars: each formed in double from the priors
    and rounded once to float32, as a Python scalar reaches a float32
    PyTorch op in ``pack_belief``."""

    nu: float
    nu_m1: float         # nu - 1
    two_nu: float        # 2 nu
    two_nu_m2: float     # 2 nu - 2
    delta: float


@functools.cache
def pack_constants(priors: PopulationPriors) -> PackConstants:
    nu = float(priors.nu)
    f32 = lambda x: float(np.float32(x))
    return PackConstants(nu=f32(nu), nu_m1=f32(nu - 1.0),
                         two_nu=f32(2.0 * nu), two_nu_m2=f32(2.0 * nu - 2.0),
                         delta=f32(priors.delta))


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


def pack_rows(bel: GammaBelief, cores: torch.Tensor,
              priors: PopulationPriors,
              alive: torch.Tensor | None = None) -> torch.Tensor:
    """[D, 16] packed parameter rows by ``pack_belief``, ALIVE in column 14
    (ones if absent)."""
    p = pack_belief(bel, cores, priors)
    a = p.a
    delta = torch.full_like(a, priors.delta)
    mask = torch.ones_like(a) if alive is None else alive.to(F32)
    cols = [p.a, p.b, p.cores, p.eu, p.eu2, p.el, p.es1, p.ess2, p.rh1, p.z1,
            p.rk, p.z2, p.e_mu_nu, delta, mask, torch.zeros_like(a)]
    return torch.stack(cols, dim=-1).to(F32).contiguous()


def moment_curves_belief_ref(bel: GammaBelief, cores: torch.Tensor,
                             t: torch.Tensor, idx: torch.Tensor,
                             frac: torch.Tensor, nd: int,
                             priors: PopulationPriors):
    """Per-row curves from the belief columns: (EL, VL), each [D, N]."""
    return _curve_rows(pack_rows(bel, cores, priors), t, idx, frac, nd)


def moment_curves_agg_belief_ref(bel: GammaBelief, cores: torch.Tensor,
                                 alive: torch.Tensor, t: torch.Tensor,
                                 idx: torch.Tensor, frac: torch.Tensor,
                                 nd: int, priors: PopulationPriors):
    """Sum over rows weighted by ``alive``: (EL, VL), each [N]; for R
    runs' columns [R, D], each [R, N], run by run."""
    if cores.ndim == 2:
        per_run = [moment_curves_agg_belief_ref(
            GammaBelief(*(x[r] for x in bel)), cores[r], alive[r], t, idx,
            frac, nd, priors) for r in range(cores.shape[0])]
        return tuple(torch.stack(x) for x in zip(*per_run))
    return moment_curves_agg_packed_ref(
        pack_rows(bel, cores, priors, alive=alive), t, idx, frac, nd)


def pack_in_kernel_order(bel: GammaBelief, cores: torch.Tensor,
                         k: PackConstants,
                         alive: torch.Tensor | None = None) -> torch.Tensor:
    """The belief kernel's in-register pack (``BeliefRow::unpack``), one
    float32 op for each of its rounded steps, with its scalars ``k``:
    [D, 16] rows in ``pack_rows``' layout."""
    a, b = bel.mu_a, bel.mu_b
    el = bel.lam_a / bel.lam_b
    el2 = (bel.lam_a * (bel.lam_a + 1.0)) / (bel.lam_b * bel.lam_b)
    es = bel.sig_a / bel.sig_b
    es2 = (bel.sig_a * (bel.sig_a + 1.0)) / (bel.sig_b * bel.sig_b)
    z1 = _clamp_away_from_zero((a + k.nu) - 1.0)
    z2 = _clamp_away_from_zero((a + k.two_nu) - 2.0)
    lg_a = torch.lgamma(a)
    log_b = torch.log(b)
    rh1 = torch.exp((torch.lgamma(z1 + 1.0) - lg_a) - k.nu_m1 * log_b) / z1
    rk = torch.exp((torch.lgamma(z2 + 1.0) - lg_a) - k.two_nu_m2 * log_b) / z2
    e_mu_nu = torch.exp((torch.lgamma(a + k.nu) - lg_a) - k.nu * log_b) / 1.0
    es1 = es + 1.0
    ess2 = es2 + 2.0 * es
    mask = torch.ones_like(a) if alive is None else alive.to(F32)
    cols = [a, b, cores, el * es1, el2 * (ess2 + 1.0), el, es1, ess2, rh1,
            z1, rk, z2, e_mu_nu, torch.full_like(a, k.delta), mask,
            torch.zeros_like(a)]
    return torch.stack(cols, dim=-1)


def agg_in_kernel_order(el: torch.Tensor, vl: torch.Tensor,
                        mask: torch.Tensor, ctas: int):
    """The aggregate kernel's order of summation over per-row curves
    ``el``, ``vl`` [D, N] weighted by ``mask`` [D], on a grid of ``ctas``
    CTAs: the two rows of a warp, each warp's rows over the blocks its CTA
    takes in turn, the CTA's warps in order, then CTA c into lane c % 32 in
    turn and a butterfly over the 32 lanes. Returns (EL, VL), each [N]."""
    d, n = el.shape
    x = torch.cat([el, vl], dim=1) * mask[:, None]        # [D, 2N]
    n_blocks = -(-d // AGG_ROWS_PER_CTA)
    x = torch.cat([x, x.new_zeros(n_blocks * AGG_ROWS_PER_CTA - d, 2 * n)])
    x = x.view(n_blocks, AGG_WARPS, 2, 2 * n)
    pair = x[:, :, 0] + x[:, :, 1]                        # [blocks, warps, 2N]
    acc = x.new_zeros(ctas, AGG_WARPS, 2 * n)
    for first in range(0, n_blocks, ctas):               # a CTA's blocks
        blocks = pair[first:first + ctas]
        acc[:len(blocks)] = acc[:len(blocks)] + blocks
    part = x.new_zeros(ctas, 2 * n)
    for w in range(AGG_WARPS):
        part = part + acc[:, w]
    lanes = x.new_zeros(32, 2 * n)
    for c in range(ctas):
        lanes[c % 32] = lanes[c % 32] + part[c]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    return lanes[0, :n], lanes[0, n:]


def agg_in_kernel_order_runs(el: torch.Tensor, vl: torch.Tensor,
                             mask: torch.Tensor, ctas: int):
    """The batched aggregate kernel's order of summation: each run's curves
    ``el``, ``vl`` [R, D, N] weighted by its ``mask`` [R, D], summed as
    ``agg_in_kernel_order`` sums one run on a grid of ``ctas`` CTAs (the
    run's virtual grid in the kernel). Returns (EL, VL), each [R, N]."""
    per_run = [agg_in_kernel_order(el[r], vl[r], mask[r], ctas)
               for r in range(el.shape[0])]
    return tuple(torch.stack(x) for x in zip(*per_run))
