"""Parameter descriptors and their materialisation.

Models declare parameters as ``P(shape, logical_axes)`` descriptors in a
nested dict (lists for per-layer stacks), as the JAX package does.
``init_params`` draws them from a ``torch.Generator`` into a ``Params``
module tree: the fan-in scaled normal, zeros and ones of the JAX package's
``init_params``. The logical axes are kept for parity with the JAX
descriptors; the port has no mesh yet, so nothing reads them (the JAX
package's ``logical_constraint`` is the identity without a mesh, and the
port calls nothing in its place).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn


class P(NamedTuple):
    """Declarative parameter: shape + logical axis names + initializer."""

    shape: tuple
    axes: tuple          # logical axis name per dim (None -> replicated)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0


class Params(nn.Module):
    """A nested parameter dict as a module: ``p["wq"]``, ``p["attn"]["wq"]``,
    ``"w_gate" in p``. Leaves are frozen ``nn.Parameter``s (the port serves;
    it does not train), children are ``Params`` or ``nn.ModuleList``s."""

    def __init__(self, items: dict):
        super().__init__()
        for name, value in items.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            else:
                self.add_module(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def keys(self) -> list:
        return [*self._parameters, *self._modules]


def is_descriptor(x: Any) -> bool:
    return isinstance(x, P)


def _draw(gen: torch.Generator, p: P, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
    std = p.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * std
    return x.to(device=device, dtype=dtype)


def init_params(gen: torch.Generator, tree: Any, dtype=torch.float32,
                device=None) -> Params:
    """Materialise a descriptor tree into a ``Params`` module (fan-in scaled
    normals drawn in float32 from ``gen``, then cast to ``dtype``). Leaves
    are drawn in sorted key order, as ``jax.tree.flatten`` orders them; the
    draws themselves differ from JAX's. ``device`` defaults to the
    generator's."""
    device = gen.device if device is None else torch.device(device)

    def build(node):
        if is_descriptor(node):
            return _draw(gen, node, dtype, device)
        if isinstance(node, dict):
            return Params({k: build(node[k]) for k in sorted(node)})
        if isinstance(node, (list, tuple)):
            return nn.ModuleList(build(x) for x in node)
        raise TypeError(f"not a descriptor tree node: {type(node).__name__}")

    return build(tree)


def _leaves(tree: Any):
    if is_descriptor(tree):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)


def count_params(tree: Any) -> int:
    """Total parameter count of a descriptor tree (no materialization)."""
    return sum(math.prod(p.shape) for p in _leaves(tree))
