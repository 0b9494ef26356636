"""State and inputs carried between the JAX package and the port.

The system has no weights: what crosses is state and inputs, as NamedTuples.
``from_reference(tree, device)`` takes one of the JAX package's NamedTuples
whose leaves are numpy arrays (e.g. ``jax.tree.map(np.asarray, x)``) and
returns the port's NamedTuple of the same name, with tensors on ``device``.
The two are matched by class name and ``_fields``. ``to_numpy(tree)`` turns a
port NamedTuple's tensors back into numpy arrays. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.belief import GammaBelief
from .core.moments import MomentCurves
from .core.policies import PolicyParams
from .core.processes import DeploymentParams, PopulationPriors, StepEvents
from .sim.core import ArrivalStream, CoreState, SimState

PORTED = {cls.__name__: cls for cls in (
    GammaBelief, DeploymentParams, ArrivalStream, SimState, CoreState,
    StepEvents, PolicyParams, PopulationPriors, MomentCurves)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


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
        return torch.from_numpy(np.array(tree, copy=True)).to(device)
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    raise TypeError(f"cannot carry a {type(tree).__name__} leaf across; "
                    "convert the reference's arrays with np.asarray first")


def to_numpy(tree):
    """The same NamedTuple with every tensor leaf as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(x) for x in tree))
    return tree
