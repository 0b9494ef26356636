"""Parameter descriptors, their materialisation, and the sharding rules.

Models declare parameters as ``P(shape, logical_axes)`` descriptors in a
nested dict (lists for per-layer stacks), as the JAX package does.
``init_params`` draws them from a ``torch.Generator`` into a ``Params``
module tree: the fan-in scaled normal, zeros and ones of the JAX package's
``init_params``. ``tree_leaves`` lists a tree's leaves in the order
``jax.tree.flatten`` lists the JAX package's: dict keys sorted, lists in
order; the optimizer and the checkpointer keep their state in that order.

The logical axes resolve to mesh axes by ``LOGICAL_RULES`` (MaxText-style),
the JAX package's ``models/spec.py`` rule for rule: ``resolve_spec`` with
its divisibility fallback (a dim that does not divide over its mesh axes
stays whole, so GQA's kv_heads or an odd vocab replicate) and single use
(a mesh axis shards one dim of a leaf at most). ``PartitionSpec`` and
``NamedSharding`` are the port's own, with JAX's entries. A ``Sharded``
tensor is laid out per a ``NamedSharding`` over a ``device.Mesh``: each
mesh device holds exactly its block, a tensor of its own (``put``), and
``gather`` assembles the whole. On a mesh of one device every placement is
the identity, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
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
    ``"w_gate" in p``. Leaves are ``nn.Parameter``s, frozen unless given as
    ``nn.Parameter``s that require grad: serving keeps them frozen, and
    ``train.step.init_train_state`` makes them trainable
    (``params.requires_grad_(True)``), or ``Sharded`` tensors placed over a
    mesh (``place_tree``). Children are ``Params`` or ``nn.ModuleList``s."""

    def __init__(self, items: dict):
        super().__init__()
        self._sharded: list = []
        for name, value in items.items():
            if isinstance(value, nn.Parameter):
                self.register_parameter(name, value)
            elif isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, Sharded):
                setattr(self, name, value)
                self._sharded.append(name)
            else:
                self.add_module(name, value)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return (name in self._parameters or name in self._modules
                or name in self._sharded)

    def keys(self) -> list:
        return [*self._parameters, *self._modules, *self._sharded]


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


# (``Sharded``, ``NamedSharding`` and ``PartitionSpec``, defined below,
# are leaves too)
LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


def tree_leaves(tree: Any) -> list:
    """The leaves of a ``Params`` tree, or of nested dicts, lists, tuples
    and NamedTuples, in ``jax.tree.flatten``'s order: dict and ``Params``
    keys sorted, sequences in order, ``None`` no leaf; a tensor, a numpy
    array, a Python number, a ``Sharded`` tensor, a ``NamedSharding`` or a
    ``PartitionSpec`` is a leaf."""
    if isinstance(tree, LEAF_TYPES):
        return [tree]
    if isinstance(tree, (dict, Params)):
        return [x for k in sorted(tree.keys()) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [x for t in tree for x in tree_leaves(t)]
    if tree is None:
        return []
    raise TypeError(f"not a tree node: {type(tree).__name__}")


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


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------

#: logical axis -> tuple of mesh axis names (missing mesh axes are skipped)
LOGICAL_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "embed": ("pod", "data"),      # FSDP / ZeRO-3 weight sharding
    "heads": ("model",),           # tensor parallel attention
    "kv_heads": ("model",),
    "mlp": ("model",),             # tensor parallel feed-forward
    "experts": ("model",),         # expert parallel MoE
    "ssm_inner": ("model",),
    "batch": ("pod", "data"),      # data parallel
    "kv_seq": ("model",),          # sequence-sharded KV cache (flash-decode)
    "seq": (),
    "head_dim": (),
    "state": (),
    "layers": (),
    "conv": (),
}


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (whole), a mesh axis name, or a tuple of
    names (the dim split over their product, the first the slowest);
    trailing ``None``s are implicit. ``tuple(spec)`` lists the entries, as
    iterating the JAX package's ``PartitionSpec`` does."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class NamedSharding:
    """A ``PartitionSpec`` over a ``device.Mesh``."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else \
            PartitionSpec(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        axes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        return f"NamedSharding(mesh={axes}, spec={self.spec!r})"


def mesh_axis_size(mesh, names: tuple) -> int:
    return math.prod(mesh.axis_size(n) for n in names if n in mesh.axis_names)


def resolve_spec(shape: tuple, axes: tuple, mesh,
                 drop_axes: tuple = ()) -> PartitionSpec:
    """Logical axes -> PartitionSpec honoring divisibility and single-use.

    ``drop_axes``: logical names to leave unsharded, e.g. serving paths drop
    'embed' (the FSDP dim) so weights replicate over the data axes instead
    of being gathered again at every decode step."""
    used: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        entry = None
        if ax is not None and ax not in drop_axes:
            mesh_axes = tuple(
                m for m in LOGICAL_RULES.get(ax, ())
                if m in mesh.axis_names and m not in used)
            if mesh_axes and dim % mesh_axis_size(mesh, mesh_axes) == 0:
                entry = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                used.update(mesh_axes)
        out.append(entry)
    while out and out[-1] is None:  # trailing Nones are implicit
        out.pop()
    return PartitionSpec(*out)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharded:
    """A tensor of ``shape`` laid out over ``sharding.mesh``: ``blocks[i]``
    is the block that mesh device i holds (row-major mesh order), a tensor
    of its own on that device. A dim whose entry names axes is split into
    equal contiguous blocks over them; a dim that does not divide, or whose
    entry is ``None``, stays whole, and devices that differ only along axes
    the spec does not name hold copies of one block. Built by ``put``."""

    __slots__ = ("blocks", "sharding", "shape", "dtype")

    def __init__(self, blocks, sharding: NamedSharding, shape, dtype):
        self.blocks = tuple(blocks)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec!r})")

    def parts(self, index: int) -> tuple:
        """(shard index, shard count) of each dim at mesh device ``index``."""
        return _parts(self.sharding, self.shape, index)

    def ranges(self, index: int) -> tuple:
        """[lo, hi) of each dim that mesh device ``index``'s block covers."""
        return tuple((s * n // c, (s + 1) * n // c)
                     for (s, c), n in zip(self.parts(index), self.shape))

    def unique(self) -> list:
        """Mesh indices of the first device holding each distinct block,
        in mesh order."""
        seen, out = set(), []
        for i in range(len(self.blocks)):
            key = self.parts(i)
            if key not in seen:
                seen.add(key)
                out.append(i)
        return out

    def gather(self, device=None, rows=None) -> torch.Tensor:
        """The whole tensor (or rows ``[lo, hi)`` of dim 0) on ``device``
        (default: the mesh's first device), assembled from the blocks that
        cover it; differentiable. Where one block holds all of it, that
        block is returned as it is (moved when it is elsewhere)."""
        device = self.device if device is None else torch.device(device)
        if self.ndim == 0:
            return self.blocks[0].to(device)
        lo, hi = (0, self.shape[0]) if rows is None else rows
        want = ((lo, hi),) + tuple((0, n) for n in self.shape[1:])
        pieces = []
        for i in self.unique():
            rng = self.ranges(i)
            cut = [(max(a, w0), min(b, w1))
                   for (a, b), (w0, w1) in zip(rng, want)]
            if all(a < b for a, b in cut):
                pieces.append((i, rng, cut))
        if len(pieces) == 1 and pieces[0][1] == want:
            return self.blocks[pieces[0][0]].to(device)
        out = torch.empty([b - a for a, b in want], dtype=self.dtype,
                          device=device)
        for i, rng, cut in pieces:
            src = self.blocks[i][tuple(slice(a - r0, b - r0)
                                       for (a, b), (r0, _) in zip(cut, rng))]
            out[tuple(slice(a - w0, b - w0)
                      for (a, b), (w0, _) in zip(cut, want))] = src.to(device)
        return out


def _parts(sharding: NamedSharding, shape, index: int) -> tuple:
    mesh = sharding.mesh
    coords = mesh.coords(index)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for n, entry in zip(shape, spec):
        names = _entry_axes(entry)
        count = math.prod(mesh.axis_size(a) for a in names)
        if count <= 1 or n % count:
            out.append((0, 1))
            continue
        s = 0
        for a in names:
            s = s * mesh.axis_size(a) + coords.get(a, 0)
        out.append((s, count))
    return tuple(out)


def put(x: torch.Tensor, sharding: NamedSharding):
    """``x`` laid out per ``sharding``: a ``Sharded`` whose every block is
    copied onto its device (logical devices of one card included, so no two
    blocks share storage). A ``Sharded`` is gathered first; on a mesh of
    one device ``x`` itself comes back, moved to that device."""
    mesh = sharding.mesh
    if isinstance(x, Sharded):
        if x.sharding == sharding:
            return x
        x = x.gather()
    if mesh.size == 1:
        return x.to(mesh.devices[0])
    blocks = []
    for i, dev in enumerate(mesh.devices):
        rng = tuple((s * n // c, (s + 1) * n // c)
                    for (s, c), n in zip(_parts(sharding, x.shape, i),
                                         x.shape))
        blk = x.detach()[tuple(slice(a, b) for a, b in rng)]
        blocks.append(blk.to(dev, copy=True,
                             memory_format=torch.contiguous_format))
    return Sharded(blocks, sharding, x.shape, x.dtype)


def gather(x, device=None):
    """A ``Sharded`` tensor whole on ``device`` (default: its first
    device's); a tensor moved there (itself when it is there)."""
    if isinstance(x, Sharded):
        return x.gather(device)
    return x if device is None else x.to(device)


def local_tree(tree: Any, device) -> Any:
    """``tree`` (a ``Params`` tree, nested dicts, lists, tuples and
    NamedTuples) with every leaf whole on ``device``: what a data-parallel
    rank gathers before it computes on its rows. A tensor already there is
    itself; ``None`` stays ``None``."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return gather(tree, device)
    if isinstance(tree, (dict, Params)):
        return {k: local_tree(tree[k], device) for k in tree.keys()}
    if isinstance(tree, (list, nn.ModuleList)):
        return [local_tree(x, device) for x in tree]
    if isinstance(tree, tuple):
        items = [local_tree(x, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            tuple(items)
    return tree


def map_leaves(fn, tree: Any, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the trees ``rest`` of the
    same structure, leaf for leaf in ``tree_leaves`` order), keeping
    ``tree``'s structure: a ``Params`` tree stays a ``Params`` tree (its
    ``nn.Parameter`` leaves keep their ``requires_grad``)."""
    others = [iter(tree_leaves(r)) for r in rest]

    def build(node):
        if isinstance(node, LEAF_TYPES):
            out = fn(node, *[next(o) for o in others])
            if isinstance(node, nn.Parameter) and isinstance(
                    out, torch.Tensor) and not isinstance(out, nn.Parameter):
                out = nn.Parameter(out, requires_grad=node.requires_grad)
            return out
        if node is None:
            return None
        if isinstance(node, Params):
            return Params({k: build(node[k]) for k in sorted(node.keys())})
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, nn.ModuleList):
            return nn.ModuleList(build(c) for c in node)
        children = [build(c) for c in node]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*children)
        return type(node)(children)

    return build(tree)


def place_tree(tree: Any, shardings: Any) -> Any:
    """Every leaf of ``tree`` ``put`` per the sharding at its place in
    ``shardings`` (a tree of ``NamedSharding``s, leaf for leaf)."""
    return map_leaves(lambda x, s: put(x, s), tree, shardings)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def _spec_tree(tree: Any, fn) -> Any:
    """``fn(descriptor)`` at every descriptor of a descriptor tree."""
    if is_descriptor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_tree(tree[k], fn) for k in sorted(tree)}
    return [_spec_tree(x, fn) for x in tree]


def abstract_params(tree: Any, dtype=torch.float32) -> Any:
    """The descriptor tree as ``meta`` tensors (shapes and dtype, nothing
    allocated), in a ``Params`` tree as ``init_params`` builds it."""
    def build(node):
        if is_descriptor(node):
            return torch.empty(node.shape, dtype=dtype, device="meta")
        if isinstance(node, dict):
            return Params({k: build(node[k]) for k in sorted(node)})
        return nn.ModuleList(build(x) for x in node)

    return build(tree)


def param_specs(tree: Any, mesh) -> Any:
    return _spec_tree(tree, lambda p: resolve_spec(p.shape, p.axes, mesh))


def param_shardings(tree: Any, mesh, drop_axes: tuple = ()) -> Any:
    return _spec_tree(tree, lambda p: NamedSharding(
        mesh, resolve_spec(p.shape, p.axes, mesh, drop_axes)))


def logical_constraint(x, axes: tuple, mesh):
    """An activation laid out by its logical axes; the identity without a
    mesh or on one device, as in the JAX package. A tensor is ``put`` per
    its resolved spec. A list is how the port's LM holds a batch-sharded
    activation over a mesh, one tensor of rows a data-parallel rank
    (``batch_ranks``): each goes to its rank's device (one tensor, a model
    that computes as one rank, stays on its own)."""
    if mesh is None or not mesh.axis_names or mesh.size == 1:
        return x
    if isinstance(x, list):
        if len(x) == 1:
            return x
        ranks = batch_ranks(mesh, sum(t.shape[0] for t in x))
        if len(ranks) != len(x):
            raise ValueError(f"{len(x)} row chunks for {len(ranks)} "
                             "data-parallel ranks")
        return [t.to(r.device) for t, r in zip(x, ranks)]
    return put(x, NamedSharding(mesh, resolve_spec(x.shape, axes, mesh)))


def shardings_for_tree(shapes: Any, axes: Any, mesh) -> Any:
    """NamedShardings for a tree of tensors (or ``meta`` tensors) given a
    structurally matching tree whose leaves are logical-axes tuples; the
    result has ``shapes``' structure."""
    a_leaves = iter(_axes_leaves(axes))
    out = map_leaves(lambda s: NamedSharding(
        mesh, resolve_spec(tuple(s.shape), next(a_leaves), mesh)), shapes)
    if next(a_leaves, None) is not None:
        raise ValueError("axes tree mismatch")
    return out


def _axes_leaves(tree: Any) -> list:
    if _is_axes_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _axes_leaves(tree[k])]
    if tree is None:
        return []
    return [x for t in tree for x in _axes_leaves(t)]


class Rank(NamedTuple):
    """A data-parallel rank of a mesh: its index, the device it computes
    on (its coordinates ``coords`` on the batch axes, 0 on the others) and
    its rows ``[lo, hi)`` of the batch."""
    index: int
    device: torch.device
    lo: int
    hi: int
    coords: dict


def batch_ranks(mesh, batch: int) -> list:
    """How a batch of ``batch`` rows splits over ``mesh``: by
    ``resolve_spec`` of the logical ``batch`` axis, contiguous equal rows a
    rank over the batch axes present; one rank on the mesh's first device
    with every row when they do not divide it (or there is no mesh)."""
    if mesh is None:
        raise ValueError("no mesh")
    spec = resolve_spec((batch,), ("batch",), mesh)
    names = _entry_axes(spec[0]) if spec else ()
    count = math.prod(mesh.axis_size(a) for a in names)
    out = []
    for r in range(count):
        coords, rest = {}, r
        for a in reversed(names):
            rest, coords[a] = divmod(rest, mesh.axis_size(a))
        out.append(Rank(r, mesh.devices[mesh.index(**coords)],
                        r * batch // count, (r + 1) * batch // count,
                        coords))
    return out


LEAF_TYPES = LEAF_TYPES + (Sharded, NamedSharding, PartitionSpec)
