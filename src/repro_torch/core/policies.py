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

PyTorch counterpart of ``repro.core.policies``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .moments import MomentCurves
from .processes import F32

ZEROTH, FIRST, SECOND = 0, 1, 2


class PolicyParams(NamedTuple):
    """Runtime parameters of an admission policy (0-d tensors)."""

    kind: torch.Tensor          # int32: ZEROTH / FIRST / SECOND
    threshold: torch.Tensor     # t  (zeroth/first)  -- cores
    rho: torch.Tensor           # Cantelli bound     (second)
    capacity: torch.Tensor      # c  -- cluster cores
    marginal_eps: torch.Tensor  # 0.0 disables Def. 4


def make_policy(kind: int, *, threshold: float = 0.0, rho: float = 0.0,
                capacity: float, marginal: bool = False,
                device=None) -> PolicyParams:
    f32 = lambda v: torch.tensor(v, dtype=F32, device=device)
    return PolicyParams(
        kind=torch.tensor(kind, dtype=torch.int32, device=device),
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
# ---------------------------------------------------------------------------

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
    first_pt = el_after <= params.threshold
    second_pt = (el_after <= params.capacity) & (cantelli <= params.rho)
    marginal_pt = cand.EL < params.marginal_eps  # Def. 4, per horizon point
    first_ok = torch.all(first_pt | marginal_pt)
    second_ok = torch.all(second_pt | marginal_pt)
    ok = torch.where(params.kind == ZEROTH, zeroth_ok,
                     torch.where(params.kind == FIRST, first_ok, second_ok))
    return ok & fits, fits


def _after(params: PolicyParams, agg_el, agg_vl, cand: MomentCurves):
    """Aggregate E[L_n] after admission and its Cantelli mass."""
    el_after = agg_el + cand.EL
    vl_after = agg_vl + cand.VL
    slack = torch.clamp(params.capacity - el_after, min=0.0)
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
        torch.where(params.kind == FIRST, torch.max(el_after),
                    torch.max(cantelli)))
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
    slack = torch.clamp(params.capacity - agg_el, min=0.0)
    cantelli = agg_vl / (agg_vl + slack**2 + 1e-30)
    first_safe = torch.all(agg_el <= params.threshold)
    second_safe = torch.all((agg_el <= params.capacity)
                            & (cantelli <= params.rho))
    true = torch.ones((), dtype=torch.bool, device=agg_el.device)
    return torch.where(params.kind == FIRST, first_safe,
                       torch.where(params.kind == SECOND, second_safe, true))


class AdmitResult(NamedTuple):
    accept: torch.Tensor   # [A] bool
    agg_el: torch.Tensor   # [N] updated aggregate
    agg_vl: torch.Tensor   # [N]
    util: torch.Tensor     # scalar


def _admit(params: PolicyParams, agg_el, agg_vl, util, cands: MomentCurves,
           cand_c0, valid, verbose: bool):
    accepts, diags = [], []
    for i in range(cand_c0.shape[0]):
        c_el, c_vl, c0 = cands.EL[i], cands.VL[i], cand_c0[i]
        cand = MomentCurves(c_el, c_vl)
        if verbose:
            acc, diag = decide_scored(params, agg_el, agg_vl, util, cand, c0)
            diags.append(diag)
        else:
            acc = decide(params, agg_el, agg_vl, util, cand, c0)
        acc = acc & valid[i]
        agg_el = torch.where(acc, agg_el + c_el, agg_el)
        agg_vl = torch.where(acc, agg_vl + c_vl, agg_vl)
        util = torch.where(acc, util + c0, util)
        accepts.append(acc)
    res = AdmitResult(torch.stack(accepts), agg_el, agg_vl, util)
    if not verbose:
        return res, None
    return res, DecisionDiag(*(torch.stack(x) for x in zip(*diags)))


def admit_sequential_verbose(
        params: PolicyParams, agg_el: torch.Tensor, agg_vl: torch.Tensor,
        util: torch.Tensor, cands: MomentCurves, cand_c0: torch.Tensor,
        valid: torch.Tensor) -> tuple[AdmitResult, DecisionDiag]:
    """``admit_sequential`` plus the per-candidate ``DecisionDiag`` (leading
    ``[A]`` axis) captured at each candidate's decision point, i.e. against
    the running aggregate after the candidates admitted before it.
    Decisions are identical to ``admit_sequential``."""
    return _admit(params, agg_el, agg_vl, util, cands, cand_c0, valid,
                  verbose=True)


def admit_sequential(params: PolicyParams, agg_el: torch.Tensor,
                     agg_vl: torch.Tensor, util: torch.Tensor,
                     cands: MomentCurves, cand_c0: torch.Tensor,
                     valid: torch.Tensor) -> AdmitResult:
    """Greedy first-come-first-served admission of a batch of A candidates.

    cands.EL/VL: [A, N]; cand_c0, valid: [A]. Invalid slots are skipped.
    """
    return _admit(params, agg_el, agg_vl, util, cands, cand_c0, valid,
                  verbose=False)[0]
