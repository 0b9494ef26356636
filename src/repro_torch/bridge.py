"""State, inputs and weights carried between the JAX package and the port.

The admission system has no weights: what crosses is state, inputs and
configurations, as NamedTuples (a fleet's ``FleetConfig``, its [C]
policies and [C]-leading core states and ``FleetMetrics`` too). ``from_reference(tree, device)`` takes one of the JAX package's
NamedTuples whose leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray,
x)``) and returns the port's NamedTuple of the same name, with tensors on
``device``. The two are matched by class name and ``_fields``; the LM's
``KVCache`` crosses the same way. ``to_numpy(tree)`` turns a port
NamedTuple's tensors back into numpy arrays. The LM scaffold has weights:
``load_lm_params(module, params_np)`` fills the port's parameter modules
from the JAX ``DecoderLM.init`` tree as numpy arrays, so that both packages
compute the same function. bfloat16 arrays (numpy's ``ml_dtypes``
bfloat16) cross exactly. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.belief import GammaBelief
from .core.moments import MomentCurves
from .core.policies import PolicyParams
from .core.processes import (DeploymentParams, PopulationPriors,
                             PseudoObservations, StepEvents)
from .models.layers import KVCache
from .obs.counters import TelemetryState
from .sim.core import (ArrivalStream, CoreState, FleetConfig, SimConfig,
                       SimState)
from .sim.routing import RouteContext
from .sim.simulator import FleetMetrics, RunMetrics

PORTED = {cls.__name__: cls for cls in (
    GammaBelief, DeploymentParams, ArrivalStream, SimState, CoreState,
    StepEvents, PolicyParams, PopulationPriors, MomentCurves, KVCache,
    PseudoObservations, SimConfig, FleetConfig, RunMetrics, FleetMetrics,
    RouteContext, TelemetryState)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tensor(a) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor; bfloat16 exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def from_reference(tree, device="cpu"):
    """The port's counterpart of a reference NamedTuple (numpy leaves)."""
    if _is_namedtuple(tree):
        name = type(tree).__name__
        cls = PORTED.get(name)
        if cls is None:
            raise TypeError(f"no port counterpart for {name}")
        if tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"{name} fields differ: reference "
                            f"{tree._fields}, port {cls._fields}")
        return cls(*(from_reference(x, device) for x in tree))
    if isinstance(tree, (np.ndarray, np.generic)):
        return _tensor(tree).to(device)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if type(tree) is tuple:       # a configuration's tuple of numbers
        return tuple(from_reference(x, device) for x in tree)
    raise TypeError(f"cannot carry a {type(tree).__name__} leaf across; "
                    "convert the reference's arrays with np.asarray first")


def to_numpy(tree):
    """The same NamedTuple with every tensor leaf as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree


def load_lm_params(module, params_np) -> None:
    """Fill the port's LM parameters (``DecoderLM.init``'s ``Params`` tree)
    in place from the JAX ``DecoderLM.init`` tree with numpy leaves. The JAX
    tree stacks the layers on a leading axis (``layers`` is a dict of
    [L, ...] arrays) where the port has one module per layer. Shapes must
    match exactly."""

    def fill(mod, tree, where):
        names = set(tree) if isinstance(tree, dict) else None
        if names != set(mod.keys()):
            raise ValueError(f"{where}: reference has {sorted(names or ())}, "
                             f"port has {sorted(mod.keys())}")
        for name, value in tree.items():
            target = mod[name]
            if name == "layers":
                fill_layers(target, value, f"{where}.layers")
            elif isinstance(value, dict):
                fill(target, value, f"{where}.{name}")
            else:
                src = _tensor(value)
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(f"{where}.{name}: reference shape "
                                     f"{tuple(src.shape)}, port "
                                     f"{tuple(target.shape)}")
                with torch.no_grad():
                    target.copy_(src)

    def fill_layers(layers, tree, where):
        depth = {np.shape(x)[0] for x in _tree_leaves(tree)}
        if depth != {len(layers)}:
            raise ValueError(f"{where}: reference stacks {sorted(depth)} "
                             f"layers, port has {len(layers)}")
        for i, mod in enumerate(layers):
            fill(mod, _index_tree(tree, i), f"{where}[{i}]")

    fill(module, params_np, "params")


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
