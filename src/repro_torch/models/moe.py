"""Mixture-of-Experts layer with sort-based token dispatch.

Top-k routing -> flatten (token, expert) assignments -> stable sort by
expert -> capacity-bounded buffer [E, C, D] -> batched per-expert matmuls ->
each token's k weighted contributions summed back. The JAX package's
``models/moe.py`` on tensors; its routing and dropping are reproduced
exactly:

* ``jax.lax.top_k`` takes the lower expert index first among equal
  probabilities, which ``torch.topk`` does not promise: the top k here come
  from a stable descending sort.
* ``jnp.argsort`` is stable, and which assignments are dropped past an
  expert's capacity depends on that order: ``torch.argsort(stable=True)``.
* The capacity is the same host expression, Python's ``round`` (half to
  even) included.

Two writes of the reference are restated as gathers, with the same values:
the capacity buffer (the reference scatters every assignment into it and
its dropped rows into one spill row, ``e * cap``; here each buffer row
gathers the assignment that fills it) and the combine (the reference's
``.at[sorted_token].add``; here each token's k contributions are brought
back to a [T, k] layout through the inverse of the sort, in ascending expert
order as the reference's scatter visits them, and summed left to right).
No float atomics, so a forward's bits do not vary from run to run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import _ROADMAP_MESH
from .spec import P

F32 = torch.float32


class MoEConfig(NamedTuple):
    d_model: int
    d_ff: int           # per-expert hidden size
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


def moe_params(cfg: MoEConfig) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": P((d, e), ("embed", "experts"), scale=0.1),
        "w_gate": P((e, d, f), ("experts", "embed", "mlp")),
        "w_in": P((e, d, f), ("experts", "embed", "mlp")),
        "w_out": P((e, f, d), ("experts", "mlp", "embed")),
    }


class MoEOut(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor      # load-balance loss (Switch-style)
    dropped_frac: torch.Tensor


class Dispatch(NamedTuple):
    """Where each (token, expert) assignment goes, in the order of the
    stable sort by expert (the reference's ``order``)."""
    order: torch.Tensor          # [T k] flat assignment index, sorted
    sorted_token: torch.Tensor   # [T k]
    starts: torch.Tensor         # [E] first sorted position of each expert
    counts: torch.Tensor         # [E] assignments routed to each expert
    keep: torch.Tensor           # [T k] bool: within its expert's capacity
    buf_idx: torch.Tensor        # [T k] buffer row; e * cap when dropped
    cap: int


def capacity(t: int, cfg: MoEConfig) -> int:
    """Rows an expert takes: the reference's host expression, Python's
    ``round`` (half to even) included."""
    return max(1, int(round(t * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values, as ``jax.lax.top_k``."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(params, cfg: MoEConfig, xf: torch.Tensor):
    """xf: [T, D] -> (probs [T, E] float32, gate [T, k], expert_idx [T, k])."""
    logits = torch.einsum("td,de->te", xf, params["router"].to(xf.dtype))
    probs = torch.softmax(logits.to(F32), dim=-1)
    gate, expert_idx = top_k(probs, cfg.top_k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    return probs, gate, expert_idx


def aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
             cfg: MoEConfig) -> torch.Tensor:
    """Switch's load-balance loss, E * sum_e f_e * p_e."""
    e = cfg.n_experts
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(expert_idx, e).to(F32), dim=1),
                    dim=0) / torch.tensor(float(cfg.top_k),
                                          device=probs.device)
    return e * torch.sum(me * ce)


def dispatch(expert_idx: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """The reference's sort, positions, capacity and kept mask."""
    t, k = expert_idx.shape
    e = cfg.n_experts
    device = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(t, device=device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.bincount(flat_expert, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=device) - starts[sorted_expert]
    cap = capacity(t, cfg)
    keep = pos < cap
    buf_idx = torch.where(keep, sorted_expert * cap + pos, e * cap)
    return Dispatch(order=order, sorted_token=flat_token[order],
                    starts=starts, counts=counts, keep=keep, buf_idx=buf_idx,
                    cap=cap)


def moe(params, cfg: MoEConfig, x: torch.Tensor) -> MoEOut:
    """x: [B, S, D] -> MoEOut with y: [B, S, D]."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    xf = x.reshape(t, d)
    probs, gate, expert_idx = route(params, cfg, xf)
    aux = aux_loss(probs, expert_idx, cfg)
    dp = dispatch(expert_idx, cfg)
    cap = dp.cap

    # buffer row (expert, c) holds sorted assignment starts[expert] + c,
    # when c < counts[expert]; zeros elsewhere, as the reference's buffer
    c = torch.arange(cap, device=x.device)
    src = (dp.starts[:, None] + c).clamp(max=t * k - 1)
    filled = c < dp.counts[:, None]                          # [E, cap]
    buf = torch.where(filled[..., None], xf[dp.sorted_token[src]],
                      torch.zeros((), dtype=x.dtype, device=x.device))

    gt = torch.einsum("ecd,edf->ecf", buf, params["w_gate"].to(x.dtype))
    up = torch.einsum("ecd,edf->ecf", buf, params["w_in"].to(x.dtype))
    y_e = torch.einsum("ecf,efd->ecd", F.silu(gt) * up,
                       params["w_out"].to(x.dtype))

    yf = y_e.reshape(e * cap, d)
    sorted_gate = gate.reshape(-1)[dp.order]
    contrib = torch.where(dp.keep[:, None],
                          yf[dp.buf_idx.clamp(max=e * cap - 1)]
                          * sorted_gate[:, None].to(x.dtype),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    # each token's k sorted positions, ascending: its contributions in the
    # order the reference's scatter-add visits them (ascending expert)
    inverse = torch.empty_like(dp.order)
    inverse[dp.order] = torch.arange(t * k, device=x.device)
    slots = torch.sort(inverse.reshape(t, k), dim=1).values
    y = contrib[slots[:, 0]]
    for j in range(1, k):
        y = y + contrib[slots[:, j]]
    # a division by a tensor: CUDA multiplies by the reciprocal of a Python
    # number, which is an ulp off the reference's 1 - n / (T k)
    dropped = 1.0 - torch.sum(dp.keep.to(F32)) / torch.tensor(
        float(t * k), device=x.device)
    return MoEOut(y=y.reshape(b, s, d), aux_loss=aux, dropped_frac=dropped)


def moe_local(params, cfg: MoEConfig, x: torch.Tensor, mesh) -> MoEOut:
    """The reference's expert-parallel dispatch over a device mesh."""
    raise NotImplementedError(
        f"expert-parallel MoE dispatch over a mesh is not ported yet: "
        f"{_ROADMAP_MESH}")
