"""Admission policies (paper §4): zeroth / first / second moment (+ marginal).

All policies are expressed over *aggregate* moment curves of the cluster
(sum over admitted deployments of E[L_n] and V[L_n]) plus the candidate's own
curves, so a decision is O(N) on the horizon grid:

  * Zeroth (Def. 1, industry baseline): admit iff util_after < t.
  * First (Def. 2, Markov's inequality):  admit iff sum E[L_n] <= t  for all n.
  * Second (Def. 3, Cantelli):            admit iff sum E[L_n] <= c  and
        sum V[L_n] / (sum V[L_n] + (c - sum E[L_n])²) <= rho  for all n.
  * Marginal heuristic (Def. 4): per-n OR with E[L_n^cand] < eps (1e-5).

Batched arrivals within one simulator step are admitted greedily in arrival
order by ``admit_sequential``, a Python loop over the A candidates that
selects with ``torch.where`` and never reads a value back to the host.

Runs: every function also takes a leading run axis, which JAX's ``vmap``
gave the reference. ``PolicyParams`` leaves may be ``[R]`` (``make_policy``
takes a tensor of thetas), curves ``[R, N]``, candidates ``[R, A, N]``, and
utilizations ``[R]``; each run's decision is its own, with the bits of the
run alone. The grid is always the last axis.

``tune_threshold`` is the paper's serial bisection, the oracle that batched
calibration (``repro_torch.tuning``) is tested against.

PyTorch counterpart of ``repro.core.policies``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .moments import MomentCurves
from .processes import F32

ZEROTH, FIRST, SECOND = 0, 1, 2


class PolicyParams(NamedTuple):
    """Runtime parameters of an admission policy: 0-d tensors, or [R], one
    for each run of a batch."""

    kind: torch.Tensor          # int32: ZEROTH / FIRST / SECOND
    threshold: torch.Tensor     # t  (zeroth/first)  -- cores
    rho: torch.Tensor           # Cantelli bound     (second)
    capacity: torch.Tensor      # c  -- cluster cores
    marginal_eps: torch.Tensor  # 0.0 disables Def. 4


def make_policy(kind, *, threshold=0.0, rho=0.0, capacity, marginal=False,
                device=None) -> PolicyParams:
    """Policy parameters from Python numbers (0-d leaves), or from
    sequences or tensors of them ([R] leaves: one policy for each run of a
    batch, e.g. a grid of thetas), as float32 / int32 tensors."""
    f32 = lambda v: torch.as_tensor(v, dtype=F32, device=device)
    return PolicyParams(
        kind=torch.as_tensor(kind, dtype=torch.int32, device=device),
        threshold=f32(threshold), rho=f32(rho), capacity=f32(capacity),
        marginal_eps=f32(1e-5 if marginal else 0.0),
    )


def geometric_grid(t_min: float = 1.0, t_max: float = 3 * 365 * 24.0,
                   n: int = 48, device=None) -> torch.Tensor:
    """Geometric horizon grid (hours), float32, from 1h..3y by default.

    The log-spaced points are interpolated in float32 exactly as
    ``jnp.linspace`` does (start*(1-s) + stop*s with s = i/(n-1), the stop
    point appended), so both packages build the same grid.
    """
    start = torch.tensor(math.log(t_min), dtype=F32, device=device)
    stop = torch.tensor(math.log(t_max), dtype=F32, device=device)
    if n == 1:
        return torch.exp(start)[None]
    step = (torch.arange(n - 1, dtype=F32, device=device)
            / torch.tensor(n - 1, dtype=F32, device=device))
    logs = torch.cat([start * (1 - step) + stop * step, stop[None]])
    return torch.exp(logs)


# ---------------------------------------------------------------------------
# Decision rules. agg_el/agg_vl: [N] aggregate curves of already-admitted
# deployments; cand: the candidate's curves [N]; util: current active cores.
# With a run axis: [R, N] curves, [R] util, c0 and policy leaves.
# ---------------------------------------------------------------------------

def _per_point(x: torch.Tensor) -> torch.Tensor:
    """A per-run policy leaf against [..., N] curves."""
    return x[..., None]


class DecisionDiag(NamedTuple):
    """Per-candidate decision diagnostics from ``decide_scored``."""

    fits: torch.Tensor       # physical capacity fit at the decision point
    score: torch.Tensor      # the policy's scalar score (kind-dependent)
    threshold: torch.Tensor  # the bound the score was compared against


def _decide_ok(params: PolicyParams, util: torch.Tensor,
               cand_c0: torch.Tensor, el_after: torch.Tensor,
               cantelli: torch.Tensor, cand: MomentCurves):
    """(admit, fits) for one candidate from the post-admission curves."""
    fits = util + cand_c0 <= params.capacity  # physical: the request must fit
    zeroth_ok = util + cand_c0 < params.threshold
    first_pt = el_after <= _per_point(params.threshold)
    second_pt = ((el_after <= _per_point(params.capacity))
                 & (cantelli <= _per_point(params.rho)))
    # Def. 4, per horizon point
    marginal_pt = cand.EL < _per_point(params.marginal_eps)
    first_ok = torch.all(first_pt | marginal_pt, dim=-1)
    second_ok = torch.all(second_pt | marginal_pt, dim=-1)
    ok = torch.where(params.kind == ZEROTH, zeroth_ok,
                     torch.where(params.kind == FIRST, first_ok, second_ok))
    return ok & fits, fits


def _after(params: PolicyParams, agg_el, agg_vl, cand: MomentCurves):
    """Aggregate E[L_n] after admission and its Cantelli mass."""
    el_after = agg_el + cand.EL
    vl_after = agg_vl + cand.VL
    slack = torch.clamp(_per_point(params.capacity) - el_after, min=0.0)
    return el_after, vl_after / (vl_after + slack**2 + 1e-30)


def decide_scored(params: PolicyParams, agg_el: torch.Tensor,
                  agg_vl: torch.Tensor, util: torch.Tensor,
                  cand: MomentCurves, cand_c0: torch.Tensor
                  ) -> tuple[torch.Tensor, DecisionDiag]:
    """Boolean admission decision plus its diagnostics for one candidate:
    the physical-fit flag and the kind's scalar score — worst-case
    ``util + c0`` (zeroth), max aggregate ``E[L_n]`` after admission
    (first), or max Cantelli mass (second) — against its bound."""
    el_after, cantelli = _after(params, agg_el, agg_vl, cand)
    ok, fits = _decide_ok(params, util, cand_c0, el_after, cantelli, cand)
    score = torch.where(
        params.kind == ZEROTH, util + cand_c0,
        torch.where(params.kind == FIRST, torch.amax(el_after, dim=-1),
                    torch.amax(cantelli, dim=-1)))
    bound = torch.where(params.kind == SECOND, params.rho, params.threshold)
    return ok, DecisionDiag(fits=fits, score=score, threshold=bound)


def decide(params: PolicyParams, agg_el: torch.Tensor, agg_vl: torch.Tensor,
           util: torch.Tensor, cand: MomentCurves,
           cand_c0: torch.Tensor) -> torch.Tensor:
    """Boolean admission decision for a single candidate."""
    el_after, cantelli = _after(params, agg_el, agg_vl, cand)
    return _decide_ok(params, util, cand_c0, el_after, cantelli, cand)[0]


def is_safe(params: PolicyParams, agg_el: torch.Tensor,
            agg_vl: torch.Tensor) -> torch.Tensor:
    """Problem 1 safety check: does the reject-all policy satisfy the
    constraint from the current belief state?"""
    capacity = _per_point(params.capacity)
    slack = torch.clamp(capacity - agg_el, min=0.0)
    cantelli = agg_vl / (agg_vl + slack**2 + 1e-30)
    first_safe = torch.all(agg_el <= _per_point(params.threshold), dim=-1)
    second_safe = torch.all((agg_el <= capacity)
                            & (cantelli <= _per_point(params.rho)), dim=-1)
    return torch.where(params.kind == FIRST, first_safe,
                       torch.where(params.kind == SECOND, second_safe,
                                   torch.ones_like(first_safe)))


class AdmitResult(NamedTuple):
    accept: torch.Tensor   # [A] bool ([R, A] with a run axis)
    agg_el: torch.Tensor   # [N] updated aggregate
    agg_vl: torch.Tensor   # [N]
    util: torch.Tensor     # scalar


def _admit(params: PolicyParams, agg_el, agg_vl, util, cands: MomentCurves,
           cand_c0, valid, verbose: bool, room=None):
    accepts, diags, states = [], [], [(agg_el, agg_vl)]
    for i in range(cand_c0.shape[-1]):
        c_el, c_vl = cands.EL[..., i, :], cands.VL[..., i, :]
        c0 = cand_c0[..., i]
        cand = MomentCurves(c_el, c_vl)
        if verbose:
            acc, diag = decide_scored(params, agg_el, agg_vl, util, cand, c0)
            diags.append(diag)
        else:
            acc = decide(params, agg_el, agg_vl, util, cand, c0)
        acc = acc & valid[..., i]
        agg_el = torch.where(acc[..., None], agg_el + c_el, agg_el)
        agg_vl = torch.where(acc[..., None], agg_vl + c_vl, agg_vl)
        util = torch.where(acc, util + c0, util)
        accepts.append(acc)
        states.append((agg_el, agg_vl))
    accept = torch.stack(accepts, dim=-1)
    if room is not None:
        # the accepted candidates past the first ``room`` come last, so the
        # aggregate of those that find a slot is the running one after the
        # first k candidates, k those whose count of accepts is within room
        k = torch.sum(torch.cumsum(accept, -1) <= room[..., None], -1)
        at = k[..., None, None].expand(*k.shape, 1, agg_el.shape[-1])
        agg_el, agg_vl = (torch.stack(x, dim=-2).gather(-2, at).squeeze(-2)
                          for x in zip(*states))
    res = AdmitResult(accept, agg_el, agg_vl, util)
    if not verbose:
        return res, None
    return res, DecisionDiag(*(torch.stack(x, dim=-1) for x in zip(*diags)))


def admit_sequential_verbose(
        params: PolicyParams, agg_el: torch.Tensor, agg_vl: torch.Tensor,
        util: torch.Tensor, cands: MomentCurves, cand_c0: torch.Tensor,
        valid: torch.Tensor, *, room: Optional[torch.Tensor] = None
        ) -> tuple[AdmitResult, DecisionDiag]:
    """``admit_sequential`` plus the per-candidate ``DecisionDiag`` (leading
    ``[A]`` axis) captured at each candidate's decision point, i.e. against
    the running aggregate after the candidates admitted before it.
    Decisions are identical to ``admit_sequential``."""
    return _admit(params, agg_el, agg_vl, util, cands, cand_c0, valid,
                  verbose=True, room=room)


def admit_sequential(params: PolicyParams, agg_el: torch.Tensor,
                     agg_vl: torch.Tensor, util: torch.Tensor,
                     cands: MomentCurves, cand_c0: torch.Tensor,
                     valid: torch.Tensor, *,
                     room: Optional[torch.Tensor] = None) -> AdmitResult:
    """Greedy first-come-first-served admission of a batch of A candidates.

    cands.EL/VL: [A, N]; cand_c0, valid: [A] (with a run axis: [R, A, N]
    and [R, A]). Invalid slots are skipped. With ``room`` (the free slots,
    0-d or [R]) the returned aggregate adds only the accepted candidates
    that find a slot, the first ``room`` accepted, one at a time in arrival
    order; the decisions are the same.
    """
    return _admit(params, agg_el, agg_vl, util, cands, cand_c0, valid,
                  verbose=False, room=room)[0]


# ---------------------------------------------------------------------------
# Threshold calibration (paper §5.2: binary search subject to the SLA).
# ---------------------------------------------------------------------------

def tune_threshold(
    run_sla: Callable[[float], float],
    lo: float,
    hi: float,
    target_sla: float,
    iters: int = 12,
) -> float:
    """Binary-search the policy parameter so the measured SLA failure rate
    is just below ``target_sla``. ``run_sla(theta)`` returns the failure rate
    of a simulation batch at parameter theta (monotone increasing in theta).

    The paper-literal serial reference oracle: one full simulation batch per
    probe. Production calibration is ``repro_torch.tuning.calibrate``, which
    evaluates whole candidate grids in one batch with CI-aware stopping and
    is tested against this function."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if run_sla(mid) <= target_sla:
            lo = mid
        else:
            hi = mid
    return lo
