"""State, inputs and weights carried between the JAX package and the port.

The admission system has no weights: what crosses is state, inputs and
configurations, as NamedTuples (a fleet's ``FleetConfig``, its [C]
policies and [C]-leading core states and ``FleetMetrics`` too, and a
``WorkloadTrace``). ``from_reference(tree, device)`` takes one of the JAX
package's NamedTuples whose leaves are numpy arrays (e.g.
``jax.tree.map(np.asarray, x)``) and returns the port's NamedTuple of the same name, with tensors on
``device``. The two are matched by class name and ``_fields``; the LM's
caches (``KVCache``, ``SSMCache``, ``MLSTMCache``, ``SLSTMState``) cross
the same way. ``to_numpy(tree)`` turns a port NamedTuple's tensors back
into numpy arrays. The LM scaffold has weights: ``load_lm_params(module,
params_np)`` fills the port's parameter modules from the JAX
``DecoderLM.init`` or ``EncDecLM.init`` tree as numpy arrays, so that both
packages compute the same function. bfloat16 arrays (numpy's
``ml_dtypes`` bfloat16) cross exactly. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core.belief import GammaBelief
from .core.moments import MomentCurves
from .core.policies import PolicyParams
from .core.processes import (DeploymentParams, PopulationPriors,
                             PseudoObservations, StepEvents)
from .models.layers import KVCache
from .models.spec import tree_leaves
from .models.ssm import SSMCache
from .models.xlstm import MLSTMCache, SLSTMState
from .obs.counters import TelemetryState
from .optim.adamw import OptState
from .optim.compression import ErrorFeedback
from .sim.core import (ArrivalStream, CoreState, FleetConfig, SimConfig,
                       SimState)
from .sim.routing import RouteContext
from .sim.simulator import FleetMetrics, RunMetrics
from .traces.schema import ScaleoutEvents, WorkloadTrace
from .train.step import TrainState

PORTED = {cls.__name__: cls for cls in (
    GammaBelief, DeploymentParams, ArrivalStream, SimState, CoreState,
    StepEvents, PolicyParams, PopulationPriors, MomentCurves, KVCache,
    PseudoObservations, SimConfig, FleetConfig, RunMetrics, FleetMetrics,
    RouteContext, TelemetryState, WorkloadTrace, ScaleoutEvents, SSMCache,
    MLSTMCache, SLSTMState)}


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
    """Fill the port's LM parameters (``DecoderLM.init``'s or
    ``EncDecLM.init``'s ``Params`` tree) in place from the JAX package's
    ``init`` tree with numpy leaves. The JAX tree has three stack shapes
    where the port has one module a layer: a homogeneous stack's
    ``layers`` is a dict of [L, ...] arrays (MoE and SSM leaves included),
    a heterogeneous one's (xLSTM) a list of dicts, and ``EncDecLM``'s
    ``encoder`` and ``decoder`` are lists. Names and shapes must match
    exactly."""

    def fill(mod, tree, where):
        if isinstance(tree, (list, tuple)):
            if not isinstance(mod, nn.ModuleList) or len(mod) != len(tree):
                raise ValueError(f"{where}: reference has a list of "
                                 f"{len(tree)}, port has {_describe(mod)}")
            for i, (m, t) in enumerate(zip(mod, tree)):
                fill(m, t, f"{where}[{i}]")
            return
        names = set(tree) if isinstance(tree, dict) else None
        if isinstance(mod, nn.ModuleList) or names != set(mod.keys()):
            raise ValueError(f"{where}: reference has {sorted(names or ())}, "
                             f"port has {_describe(mod)}")
        for name, value in tree.items():
            target = mod[name]
            if isinstance(target, nn.ModuleList) and isinstance(value, dict):
                fill_stacked(target, value, f"{where}.{name}")
            elif isinstance(value, (dict, list, tuple)):
                fill(target, value, f"{where}.{name}")
            else:
                src = _tensor(value)
                if tuple(src.shape) != tuple(target.shape):
                    raise ValueError(f"{where}.{name}: reference shape "
                                     f"{tuple(src.shape)}, port "
                                     f"{tuple(target.shape)}")
                with torch.no_grad():
                    target.copy_(src)

    def fill_stacked(layers, tree, where):
        depth = {np.shape(x)[0] for x in _tree_leaves(tree)}
        if depth != {len(layers)}:
            raise ValueError(f"{where}: reference stacks {sorted(depth)} "
                             f"layers, port has {len(layers)}")
        for i, mod in enumerate(layers):
            fill(mod, _index_tree(tree, i), f"{where}[{i}]")

    fill(module, params_np, "params")


def _describe(mod) -> str:
    if isinstance(mod, nn.ModuleList):
        return f"a list of {len(mod)}"
    return str(sorted(mod.keys()))


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


# ---------------------------------------------------------------------------
# Train states. The port keeps one tensor a parameter in
# ``models.spec.tree_leaves`` order, with one module a layer; the JAX package
# stacks a homogeneous decoder stack's leaves on a leading [L, ...] axis.
# ---------------------------------------------------------------------------


def _stacked(model) -> bool:
    """Whether the JAX package stacks this model's ``layers``."""
    layer_types = getattr(model, "layer_types", None)
    return (layer_types is not None and len(set(layer_types)) == 1
            and model.cfg.scan_layers)


def _port_leaves(model, tree_np) -> list:
    """A JAX-layout parameter-shaped tree (numpy leaves) as arrays in the
    port's leaf order."""
    if _stacked(model):
        n = len(model.layer_types)
        tree_np = {**tree_np,
                   "layers": [_index_tree(tree_np["layers"], i)
                              for i in range(n)]}
    return [np.asarray(a) for a in tree_leaves(tree_np)]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def lm_leaves_to_numpy(model, leaves) -> dict:
    """Tensors in the port's leaf order of ``model``'s parameters (the
    parameters themselves, a moment, gradients) as the JAX package's
    parameter tree of numpy arrays: homogeneous decoder stacks on a leading
    [L, ...] axis."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        return to_numpy(next(it)).copy()

    tree = build(model.param_descriptors())
    if next(it, None) is not None:
        raise ValueError("more leaves than the model has parameters")
    if _stacked(model):
        tree["layers"] = _stack(tree["layers"])
    return tree


def load_train_state(model, state_np, device="cpu") -> TrainState:
    """The port's ``TrainState`` of the JAX package's (its NamedTuples with
    numpy leaves): parameters through ``load_lm_params`` (trainable), then
    AdamW's m, v and step and the error feedback, each leaf mapped as the
    parameters are."""
    params = model.init(torch.Generator().manual_seed(0), device=device)
    load_lm_params(params, state_np.params)
    params.requires_grad_(True)

    def leaves(tree):
        return [_tensor(a).to(device) for a in _port_leaves(model, tree)]

    opt = OptState(m=leaves(state_np.opt.m), v=leaves(state_np.opt.v),
                   step=_tensor(state_np.opt.step).to(device))
    ef = (None if state_np.ef is None
          else ErrorFeedback(residual=leaves(state_np.ef.residual)))
    return TrainState(params=params, opt=opt, ef=ef)


def train_state_to_numpy(model, state: TrainState) -> TrainState:
    """A port ``TrainState`` in the JAX package's layout: the same
    NamedTuples holding its trees of numpy arrays (``jax.tree.leaves`` lists
    both packages' states in one order)."""
    tree = lambda xs: lm_leaves_to_numpy(model, xs)
    return TrainState(
        params=tree(tree_leaves(state.params)),
        opt=OptState(m=tree(state.opt.m), v=tree(state.opt.v),
                     step=to_numpy(state.opt.step)),
        ef=None if state.ef is None else ErrorFeedback(
            residual=tree(state.ef.residual)))
