"""The train step, the JAX package's ``train/step.py`` on one device: loss
and gradients (accumulated over microbatches), optional int8 gradient
compression with error feedback, then AdamW.

The JAX step is one jit-compiled function over a sharded state; here it is
eager PyTorch on the parameters' device, and it updates the state's
tensors in place. The mesh (``state_shardings``, ``batch_shardings``,
``abstract_train_state`` and ``mesh=``) is not ported (ROADMAP Queue A,
item 5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import resolve_device
from ..models.lm import _no_mesh
from ..models.spec import tree_leaves
from ..optim import adamw
from ..optim.compression import (ErrorFeedback, compress_with_feedback,
                                 init_error_feedback)


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


def make_train_step(model, opt_cfg: adamw.AdamWConfig, mesh=None, *,
                    microbatches: int = 1, compress: bool = False):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    {"loss", "nll", "aux", "grad_norm", "lr"} as 0-d tensors. ``batch`` is a
    dict of tensors on the parameters' device with a leading batch axis,
    cut into ``microbatches`` equal slices: the gradients are summed in
    float32 and scaled by 1 / microbatches, the loss is the mean over the
    slices, and nll and aux are the last slice's."""
    _no_mesh(mesh)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        if microbatches == 1:
            loss, metrics = model.loss(params, batch)
            return loss, metrics, list(torch.autograd.grad(loss, leaves))
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        for i in range(microbatches):
            mb = {k: v.narrow(0, i * (v.shape[0] // microbatches),
                              v.shape[0] // microbatches)
                  for k, v in batch.items()}
            loss, metrics = model.loss(params, mb)
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
                acc += g
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        return loss_sum * inv, metrics, [g * inv for g in grads]

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = grads_of(state.params, batch)
        ef = state.ef
        if compress and ef is not None:
            grads, ef = compress_with_feedback(grads, ef)
        params, opt, opt_metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(params, opt, ef), {
            **metrics, **opt_metrics, "loss": loss.detach()}

    return step
