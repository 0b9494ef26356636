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

``moe_local`` is the reference's expert-parallel dispatch over a device
mesh (its ``shard_map`` lane): each ``model`` rank routes a data-parallel
rank's tokens to the experts it owns, on its own device, and the ranks'
outputs are summed in rank order (the ``psum``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import Mesh
from .spec import P, Sharded, batch_ranks, gather

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


def bin_counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``idx`` in [0, n), int64, as
    a scatter-add of ones: the same integers, and an op that has a ``meta``
    kernel (``bincount`` has none, so the dry run could not count MoE)."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


def dispatch(expert_idx: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """The reference's sort, positions, capacity and kept mask."""
    t, k = expert_idx.shape
    e = cfg.n_experts
    device = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(t, device=device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = bin_counts(flat_expert, e)
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
    # each token's k contributions in the order the reference's
    # scatter-add visits them (ascending expert)
    y = _combine(contrib, dp.order, t, k)
    # a division by a tensor: CUDA multiplies by the reciprocal of a Python
    # number, which is an ulp off the reference's 1 - n / (T k)
    dropped = 1.0 - torch.sum(dp.keep.to(F32)) / torch.tensor(
        float(t * k), device=x.device)
    return MoEOut(y=y.reshape(b, s, d), aux_loss=aux, dropped_frac=dropped)


def _combine(contrib: torch.Tensor, order: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """y [T, D]: each token's k contributions (in sorted order ``order``)
    summed left to right in ascending sorted position, the order in which
    the reference's scatter-add visits them."""
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(t * k, device=order.device)
    slots = torch.sort(inverse.reshape(t, k), dim=1).values
    y = contrib[slots[:, 0]]
    for j in range(1, k):
        y = y + contrib[slots[:, j]]
    return y


def _expert_slice(w, lo: int, hi: int, device) -> torch.Tensor:
    """Experts [lo, hi) of an [E, ...] weight, whole in its other dims, on
    ``device`` (a ``Sharded`` weight gathers only the blocks that hold
    them)."""
    if isinstance(w, Sharded):
        return w.gather(device, rows=(lo, hi))
    return w[lo:hi].to(device)


def moe_local_rank(params, cfg: MoEConfig, x: torch.Tensor, mesh,
                   coords: dict) -> MoEOut:
    """One data-parallel rank of ``moe_local``: x [b, s, D], its tokens, on
    the rank's device; ``coords`` its coordinates on the batch axes. Model
    rank m (the device at ``coords`` and model = m) routes the tokens to its
    experts [m e_loc, (m + 1) e_loc): the reference's stable sort by local
    expert with the drop bucket e_loc for tokens routed elsewhere, its
    capacity max(1, round(t k / E cf)) of the local token count t, its
    buffer and combine. The ranks' outputs and dropped counts are summed in
    rank order on x's device."""
    n_model = mesh.axis_size("model")
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // n_model
    b, s, d = x.shape
    t = b * s
    home = x.device
    xf = x.reshape(t, d)
    probs, gate, expert_idx = route(
        {"router": gather(params["router"], home)}, cfg, xf)
    aux = aux_loss(probs, expert_idx, cfg)
    cap = capacity(t, cfg)
    y = n_drop = None
    for m in range(n_model):
        dev = mesh.devices[mesh.index(**coords, model=m)]
        lo = m * e_loc
        flat_e = expert_idx.reshape(-1).to(dev)
        flat_t = torch.arange(t, device=dev).repeat_interleave(k)
        is_local = (flat_e >= lo) & (flat_e < lo + e_loc)
        le = torch.where(is_local, flat_e - lo, e_loc)
        order = torch.argsort(le, stable=True)
        se, st = le[order], flat_t[order]
        counts = bin_counts(le, e_loc + 1)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(t * k, device=dev) - starts[se]
        keep = (pos < cap) & (se < e_loc)
        buf_idx = torch.where(keep, se * cap + pos, e_loc * cap)
        xd = xf.to(dev)
        c = torch.arange(cap, device=dev)
        src = (starts[:e_loc, None] + c).clamp(max=t * k - 1)
        filled = c < counts[:e_loc, None]
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        buf = torch.where(filled[..., None], xd[st[src]], zero)
        wg, wi, wo = (_expert_slice(params[n], lo, lo + e_loc, dev).to(
            x.dtype) for n in ("w_gate", "w_in", "w_out"))
        gt = torch.einsum("ecd,edf->ecf", buf, wg)
        up = torch.einsum("ecd,edf->ecf", buf, wi)
        y_e = torch.einsum("ecf,efd->ecd", F.silu(gt) * up, wo)
        yf = y_e.reshape(e_loc * cap, d)
        sg = gate.reshape(-1).to(dev)[order]
        contrib = torch.where(keep[:, None],
                              yf[buf_idx.clamp(max=e_loc * cap - 1)]
                              * sg[:, None].to(x.dtype), zero)
        y_m = _combine(contrib, order, t, k).to(home)
        drop_m = torch.sum((~keep & is_local[order]).to(F32)).to(home)
        y = y_m if y is None else y + y_m
        n_drop = drop_m if n_drop is None else n_drop + drop_m
    dropped = n_drop / torch.tensor(float(t * k), device=home)
    return MoEOut(y=y.reshape(b, s, d), aux_loss=aux, dropped_frac=dropped)


def moe_local(params, cfg: MoEConfig, x: torch.Tensor, mesh) -> MoEOut:
    """The reference's expert-parallel MoE over ``mesh`` (a
    ``device.Mesh``): x [B, S, D] split into its data-parallel ranks' rows
    (``spec.batch_ranks``), each through ``moe_local_rank``; y the ranks'
    rows on x's device. As the reference's ``shard_map`` returns one
    replicated value of what differs over data ranks, ``aux_loss`` and
    ``dropped_frac`` are the first rank's. Falls back to ``moe`` where the
    reference does: no ``model`` axis over 1, or experts that do not
    divide over it."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a device.Mesh, got "
                        f"{type(mesh).__name__}")
    n_model = mesh.axis_size("model")
    if n_model <= 1 or cfg.n_experts % n_model != 0:
        return moe(params, cfg, x)
    outs = [moe_local_rank(params, cfg, x[r.lo:r.hi].to(r.device), mesh,
                           r.coords)
            for r in batch_ranks(mesh, x.shape[0])]
    y = torch.cat([o.y.to(x.device) for o in outs])
    return MoEOut(y=y, aux_loss=outs[0].aux_loss.to(x.device),
                  dropped_frac=outs[0].dropped_frac.to(x.device))

