"""The train step, the JAX package's ``train/step.py``: loss and gradients
(accumulated over microbatches), optional int8 gradient compression with
error feedback, then AdamW.

The JAX step is one jit-compiled function over a state sharded by GSPMD;
here it is eager PyTorch, and it updates the state's tensors in place.
Without a mesh (or on a mesh of one device) it runs on the parameters'
device. Over a ``device.Mesh`` the state is laid out per
``state_shardings`` (``spec.Sharded`` leaves, ``spec.place_tree``) and the
batch splits into data-parallel ranks over the batch axes (``pod``,
``data``): each rank gathers its own copy of the parameters onto its
device, computes the loss of its rows and their gradients there, and the
ranks' gradients are reduced in rank order into each device's block of the
gradient (the reduce-scatter); compression quantizes each reduced
gradient in its global order; AdamW updates block by block
(``optim.adamw``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..models.lm import _mesh_of, combine_rank_losses
from ..models.spec import (NamedSharding, PartitionSpec, Sharded, gather,
                           map_leaves, resolve_spec, tree_leaves)
from ..optim import adamw
from ..optim.compression import (ErrorFeedback, compress_with_feedback,
                                 init_error_feedback)

F32 = torch.float32


class TrainState(NamedTuple):
    params: object                  # the model's ``Params`` tree
    opt: adamw.OptState
    ef: Optional[ErrorFeedback]     # gradient-compression error feedback


def init_train_state(model, gen: torch.Generator, *, compress: bool = False,
                     param_dtype=torch.float32, device="cuda") -> TrainState:
    """Parameters from ``model.init(gen)`` on ``device`` (the card unless the
    caller passes ``"cpu"``), made trainable; zero moments; zero error
    feedback with ``compress``."""
    params = model.init(gen, param_dtype, resolve_device(device))
    params.requires_grad_(True)
    return TrainState(
        params=params,
        opt=adamw.init_opt_state(params),
        ef=init_error_feedback(params) if compress else None,
    )


def abstract_train_state(model, *, compress: bool = False,
                         param_dtype=torch.float32) -> TrainState:
    """``init_train_state``'s structure, shapes and dtypes as ``meta``
    tensors (nothing allocated)."""
    params = model.abstract_params(param_dtype)
    f32 = [torch.empty(p.shape, dtype=F32, device="meta")
           for p in tree_leaves(params)]
    return TrainState(
        params=params,
        opt=adamw.OptState(m=list(f32), v=list(f32),
                           step=torch.empty((), dtype=torch.int32,
                                            device="meta")),
        ef=ErrorFeedback(list(f32)) if compress else None,
    )


def state_shardings(model, mesh, *, compress: bool = False) -> TrainState:
    """A ``NamedSharding`` for each leaf of the train state: the parameters'
    (``model.param_shardings``) for them, their moments and their error
    feedback; the step replicated."""
    ps = model.param_shardings(mesh)
    leaves = tree_leaves(ps)
    return TrainState(
        params=ps,
        opt=adamw.OptState(m=list(leaves), v=list(leaves),
                           step=NamedSharding(mesh, PartitionSpec())),
        ef=ErrorFeedback(list(leaves)) if compress else None,
    )


def batch_shardings(batch_specs: dict, mesh) -> dict:
    """The batch's leading axis over the data axes (anything with a
    ``shape`` describes a leaf)."""
    out = {}
    for k, v in batch_specs.items():
        axes = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = NamedSharding(mesh, resolve_spec(tuple(v.shape), axes,
                                                  mesh))
    return out


def _rank_copy(params, device):
    """A data-parallel rank's own copy of the parameters on ``device``:
    every leaf gathered whole, a fresh leaf that takes gradients."""
    return map_leaves(lambda x: nn.Parameter(
        gather(x, device).detach(), requires_grad=True), params)


def _reduce_into(acc: list, params: list, grads: list) -> list:
    """Add one rank's gradients (whole, on its device) into ``acc`` laid out
    as ``params`` (a list of blocks a leaf; None for the first rank)."""
    out = []
    for j, (p, g) in enumerate(zip(params, grads)):
        if not isinstance(p, Sharded):
            blocks = [g.to(p.device)]
        else:
            blocks = [g[tuple(slice(a, b) for a, b in p.ranges(i))].to(
                blk.device) for i, blk in enumerate(p.blocks)]
        if acc is None:
            out.append([b.to(F32) for b in blocks])
        else:
            out.append([a + b for a, b in zip(acc[j], blocks)])
    return out


def _as_leaves(params: list, blocks: list) -> list:
    """Gradient blocks as leaves laid out like the parameters'."""
    return [Sharded(b, p.sharding, p.shape, F32) if isinstance(p, Sharded)
            else b[0] for p, b in zip(params, blocks)]


def make_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    {"loss", "nll", "aux", "grad_norm", "lr"} as 0-d tensors. ``batch`` is a
    dict of tensors with a leading batch axis, cut into ``microbatches``
    equal slices: the gradients are summed in float32 and scaled by 1 /
    microbatches, the loss is the mean over the slices, and nll and aux are
    the last slice's. Over ``mesh`` (more than one device) the state is the
    one ``state_shardings`` lays out and each slice splits over the
    data-parallel ranks; a rank's loss is its rows' part of the slice's
    mean, and the aux loss the first rank's."""
    mesh = _mesh_of(mesh)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        if microbatches == 1:
            loss, metrics = model.loss(params, batch)
            return loss, metrics, list(torch.autograd.grad(loss, leaves))
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(microbatches):
            mb = _slice(batch, i)
            loss, metrics = model.loss(params, mb)
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
                acc += g
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        return loss_sum * inv, metrics, [g * inv for g in grads]

    def _slice(batch, i):
        return {k: v.narrow(0, i * (v.shape[0] // microbatches),
                            v.shape[0] // microbatches)
                for k, v in batch.items()}

    def mesh_grads_of(params, batch):
        leaves = tree_leaves(params)
        rows = batch["tokens"].shape[0] // microbatches
        ranks = model._ranks(mesh, rows)
        copies = [_rank_copy(params, r.device) for r in ranks]
        home = ranks[0].device
        loss_sum = acc = None
        for i in range(microbatches):
            mb = _slice(batch, i) if microbatches > 1 else batch
            parts, mb_acc = [], None
            for r, copy in zip(ranks, copies):
                part, aux = model.rank_loss(copy, mb, mesh, r)
                parts.append((part.detach(), aux.detach()))
                objective = part
                if r.index == 0 and model.cfg.family == "moe":
                    objective = objective + (model.cfg.moe_aux_coef * aux
                                             / model.cfg.n_layers)
                grads = torch.autograd.grad(objective, tree_leaves(copy),
                                            allow_unused=True)
                grads = [torch.zeros_like(c) if g is None else g
                         for g, c in zip(grads, tree_leaves(copy))]
                mb_acc = _reduce_into(mb_acc, leaves, grads)
                del grads
            loss, metrics = combine_rank_losses(model.cfg, parts, home)
            if microbatches == 1:
                return loss, metrics, _as_leaves(leaves, mb_acc)
            acc = mb_acc if acc is None else [
                [a + b for a, b in zip(x, y)] for x, y in zip(acc, mb_acc)]
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / microbatches
        return loss_sum * inv, metrics, _as_leaves(
            leaves, [[b * inv for b in x] for x in acc])

    def step(state: TrainState, batch: dict):
        if mesh is None:
            loss, metrics, grads = grads_of(state.params, batch)
        else:
            loss, metrics, grads = mesh_grads_of(state.params, batch)
        ef = state.ef
        if compress and ef is not None:
            grads, ef = compress_with_feedback(grads, ef)
        params, opt, opt_metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(params, opt, ef), {
            **metrics, **opt_metrics, "loss": loss.detach()}

    return step
