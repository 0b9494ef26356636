"""AdamW with gradient clipping and a warmup-cosine schedule, the JAX
package's ``optim/adamw.py``.

The state keeps the reference's float32 moments, one tensor a parameter in
``models.spec.tree_leaves`` order (the order ``jax.tree.flatten`` gives the
JAX package's tree), and its int32 step. Every division that the reference
writes with a Python number divides by a tensor here: a CUDA division by a
host scalar multiplies by its reciprocal, an ulp off IEEE division, where a
tensor divisor divides on both devices.

A state laid out over a mesh (``train.step.state_shardings``) has
``spec.Sharded`` leaves: the global norm sums each distinct block's sum of
squares, leaf after leaf and block after block in mesh order, on the first
leaf's device, and every block (each copy of a replicated one too) is
updated on its own device with the same arithmetic.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..models.spec import Sharded, gather, put, tree_leaves

F32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class OptState(NamedTuple):
    m: list                 # float32, one a parameter
    v: list
    step: torch.Tensor      # 0-d int32


def init_opt_state(params: Any) -> OptState:
    """Zero moments for the leaves of ``params`` (a ``Params`` tree, a
    dict or a list of tensors), on their devices."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    return OptState(m=[zeros(p) for p in leaves],
                    v=[zeros(p) for p in leaves],
                    step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine to 10%."""
    s = step.to(F32)
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    frac = torch.clamp(
        (s - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares
    (of a ``Sharded`` leaf, its distinct blocks' sums in mesh order)."""
    leaves = tree_leaves(tree)
    home = leaves[0].device
    total = torch.zeros((), dtype=F32, device=home)
    for g in leaves:
        if isinstance(g, Sharded):
            for i in g.unique():
                total = total + torch.sum(g.blocks[i].to(F32) ** 2).to(home)
        else:
            total = total + torch.sum(g.to(F32) ** 2)
    return torch.sqrt(total)


def _blocks(x) -> tuple:
    return x.blocks if isinstance(x, Sharded) else (x,)


@torch.no_grad()
def apply_updates(
    cfg: AdamWConfig,
    params: Any,
    grads: Any,
    state: OptState,
    compress: Optional[Callable[[list], list]] = None,
) -> tuple[Any, OptState, dict]:
    """One AdamW step. ``grads`` are the gradients of ``params``' leaves, in
    their order. The parameters and the moments are updated in place, so
    the same ``Params`` module carries on; returns (params, new state,
    {"grad_norm", "lr"})."""
    leaves = tree_leaves(params)
    grads = tree_leaves(grads)
    if len(grads) != len(leaves):
        raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                         "parameters")
    gnorm = global_norm(grads)
    # a Python number over a tensor is its reciprocal times the number in
    # torch (``Tensor.__rtruediv__``): divide explicitly
    scale = torch.clamp(torch.div(_f32(cfg.clip_norm, gnorm), gnorm + 1e-9),
                        max=1.0)
    if compress is not None:
        grads = compress([g.to(F32) * scale for g in grads])
        scale = torch.ones((), dtype=F32, device=scale.device)

    step = gather(state.step) + 1
    lr = schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, sf), sf)

    for p, m, v, g in zip(leaves, state.m, state.v, grads):
        blocks = [_blocks(x) for x in (p, m, v, g)]
        if len({len(b) for b in blocks}) != 1:
            raise ValueError("a parameter, its moments and its gradient must "
                             "share one layout")
        for pb, mb, vb, gb in zip(*blocks):
            dev = pb.device
            _update(cfg, pb, mb, vb, gb.to(F32) * scale.to(dev), lr.to(dev),
                    b1c.to(dev), b2c.to(dev))
    if isinstance(state.step, Sharded):
        step = put(step, state.step.sharding)
    return params, OptState(state.m, state.v, step), {
        "grad_norm": gnorm, "lr": lr}


def _update(cfg: AdamWConfig, p, m, v, g, lr, b1c, b2c) -> None:
    """One parameter's (or block's) moments and value, in place."""
    m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
    v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
    p32 = p.to(F32)
    delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
        + cfg.weight_decay * p32
    p.copy_((p32 - lr * delta).to(p.dtype))
