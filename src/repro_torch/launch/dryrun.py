"""Multi-pod dry run: count every (arch × shape × mesh) cell on shape-only
tensors.

The JAX package lowers and compiles each cell under GSPMD and asks the
compiler for its memory, cost and collectives. The port has no compiler to
ask, so it runs its own entry points, eagerly, on tensors that hold no data
and counts what they do:

* ``train``: ``train.step.make_train_step`` (with the arch's
  ``TRAIN_MICROBATCHES``) on ``abstract_train_state``, laid out per
  ``state_shardings``, its parameters made to require grad;
* ``prefill``: ``model.prefill(params, tokens, mesh[, frames=])``;
* ``decode``: ``model.decode_step`` against ``model.init_cache(B, S,
  bf16)`` laid out per ``cache_shardings``; under a variant with
  ``_serve_params``, bf16 parameters with ``drop_axes=("embed",)``.

The production meshes are ``launch.mesh.make_production_mesh(device=
"meta")``: 256 or 512 devices ``meta:0``, ``meta:1``, ... Every tensor is a
``MeshMeta``, a ``meta`` tensor (shape and dtype, no storage) that carries
the mesh device it lies on, so the port's code runs as it does on a host of
that many devices: a rank computes on its device, ``x.to(d)`` is a copy
from one device to another (or nothing, on the same device) and a tensor
made ``like`` another lands on its device. Nothing is allocated.

A ``TorchDispatchMode`` counts each operation on the device that runs it:
FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
attention), bytes as what an eager operation reads and writes (each input
and each output once; a view moves nothing), and the high-water mark of
the live bytes the step allocates. A copy between two devices is counted
as wire bytes received by its destination, by kind: the caller that moves
it names the collective it stands for (``Sharded.gather`` and the shard
concatenation of the sequence-sharded cache an all-gather, the rank-order
gradient reduce a reduce-scatter, the combines of partial results an
all-reduce, expert-parallel dispatch an all-to-all, every other copy a
collective-permute). For a gather of g equal blocks onto a device that
holds one, the bytes received are the ring formula's X (g - 1) / g of the
JAX package's ``parse_collectives``, as they are for the reduce-scatter;
a combine onto one device receives (g - 1) X, not a ring all-reduce's
2 X (g - 1) / g: the record holds what the port's design moves.

The port computes a data-parallel rank's whole block on the device at its
batch coordinates (0 on ``model``), so the devices differ: the record
gives the busiest device's FLOPs, bytes, wire bytes and memory (what bounds
a step), and the sum over the devices (``cost_sum_over_devices``), never
the sum divided by the device count.

Every layer and every iteration of the SSD chunk loop and the sLSTM time
loop is an operation here, so a count needs no correction for loop bodies.
A production cell at full depth takes minutes to hours of Python dispatch
(a rank gathers each of 256 or 512 blocks of every weight), so a cell is
counted at depths k and 2k (k = 2 for the alternating xLSTM stack, else 1)
and its FLOPs, bytes and wire bytes extrapolated linearly to the full
depth, as the JAX package's ``extrapolate_depth`` does: the layers of a
stack are alike, so the extrapolation equals the full count
(``tests/test_torch_dryrun.py``). The xLSTM stack's train and prefill
cells, affine in S, are counted at two lengths as well
(``_probe_seq_lens``). A probed cell's memory is the arguments' and
outputs' at full depth, and no temporary size; ``lower_cell(...,
probes=False)`` counts every layer and records the temporary size too.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --single-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--multi-pod-only|--single-pod-only] [--variant opt] [--jobs 8]

Records go to ``artifacts/dryrun_torch/`` (``--out``), one JSON file a
cell, with the keys of the JAX package's ``lower_cell``;
``repro_torch.benchmarks.roofline`` reads them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)
from torch.utils.flop_counter import flop_registry

from ..configs.shapes import SHAPES, applicable
from ..device import Mesh
from ..models import ARCH_NAMES, build_model, get_config, input_specs
from ..models.spec import NamedSharding, Sharded, map_leaves, tree_leaves
from ..optim.adamw import AdamWConfig
from ..train.step import (abstract_train_state, make_train_step,
                          state_shardings)
from .mesh import make_production_mesh

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "../../../artifacts/dryrun_torch")

#: per-arch gradient-accumulation microbatches for train_4k (the JAX
#: package's, arch for arch)
TRAIN_MICROBATCHES = {
    "dbrx-132b": 8, "chameleon-34b": 8, "granite-20b": 4, "qwen3-14b": 4,
    "moonshot-v1-16b-a3b": 4, "starcoder2-3b": 2, "hymba-1.5b": 2,
    "llama3.2-1b": 2, "xlstm-125m": 1, "whisper-small": 1,
}

#: optimization variants (the JAX package's): config overrides, and
#: ``_serve_params`` for bf16 decode parameters replicated over the data
#: axes
VARIANTS = {
    "baseline": {},
    "opt": {"attn_chunk": 512, "moe_local_dispatch": True},
    "opt_chunk_only": {"attn_chunk": 512},
    "opt_moe_only": {"moe_local_dispatch": True},
    "opt_chunk256": {"attn_chunk": 256, "moe_local_dispatch": True},
    "opt_chunk1024": {"attn_chunk": 1024, "moe_local_dispatch": True},
    "opt_serve": {"attn_chunk": 512, "moe_local_dispatch": True,
                  "moe_capacity_factor": 4.0,
                  "_serve_params": True},
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: (source file, function) of the callers whose copies between devices
#: stand for a collective; the innermost on the stack names a copy's kind
_KIND_OF_CALLER = {
    ("spec.py", "Sharded.gather"): "all-gather",
    ("layers.py", "_shard_rows"): "all-gather",
    ("step.py", "_reduce_into"): "reduce-scatter",
    ("layers.py", "_sharded_decode"): "all-reduce",
    ("lm.py", "combine_rank_losses"): "all-reduce",
    ("adamw.py", "global_norm"): "all-reduce",
    ("moe.py", "moe_local_rank"): "all-to-all",
}

META = torch.device("meta")
_TO_COPY = torch.ops.aten._to_copy.default
#: distinct indices a torch device can carry (``c10::DeviceIndex``, int8)
_SLOTS = 128


class DeviceSlots:
    """The mesh's devices as ``meta:k`` devices. A torch device index holds
    at most 127, fewer than a production mesh's 256 or 512 devices, so a
    mesh device is lent one of 128 slots while code holds it: the devices
    with coordinate 0 on ``model`` (the data-parallel ranks', which carry
    every autograd graph) keep theirs, the others share the rest, the
    least recently named giving its slot up. A mesh of at most 128 devices
    is ``meta:i`` for device i."""

    def __init__(self, mesh):
        n = mesh.size
        self.n = n
        self.slot_of: dict = {}
        self.owner = [None] * _SLOTS
        self._devices = [torch.device("meta", k) for k in range(_SLOTS)]
        if n <= _SLOTS:
            pinned = range(n)
        else:
            pinned = [i for i in range(n)
                      if mesh.coords(i).get("model", 0) == 0]
        for k, i in enumerate(pinned):
            self.slot_of[i], self.owner[k] = k, i
        self._pinned = len(pinned)
        self._lent: dict = {}        # slot -> None, least recent first
        for k in range(self._pinned, _SLOTS):
            self._lent[k] = None

    def device(self, i: int) -> torch.device:
        """``meta:k`` for mesh device i."""
        k = self.slot_of.get(i)
        if k is None:
            k = next(iter(self._lent))
            if self.owner[k] is not None:
                del self.slot_of[self.owner[k]]
            self.slot_of[i], self.owner[k] = k, i
        if k >= self._pinned:
            del self._lent[k]
            self._lent[k] = None
        return self._devices[k]

    def index(self, device: torch.device) -> int:
        """The mesh device that ``meta:k`` names now."""
        return self.owner[device.index]


class MeshDevices(tuple):
    """A mesh's ``devices``, each named through ``DeviceSlots`` as it is
    read; equal only to itself."""

    def __new__(cls, slots: DeviceSlots):
        out = super().__new__(cls, range(slots.n))
        out.slots = slots
        return out

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.slots.device(j) for j in range(self.slots.n)[i]]
        return self.slots.device(range(self.slots.n)[i])

    def __iter__(self):
        return (self.slots.device(i) for i in range(self.slots.n))

    def __eq__(self, other) -> bool:
        return self is other

    def __hash__(self) -> int:
        return id(self)


def counted_mesh(mesh):
    """``mesh`` (of any devices) with ``MeshDevices``: the mesh a count
    runs over, and its ``DeviceSlots``."""
    slots = DeviceSlots(mesh)
    return mesh._replace(devices=MeshDevices(slots)), slots


class MeshMeta(torch.Tensor):
    """A ``meta`` tensor on mesh device ``tag``: ``elem`` is the plain
    ``meta`` tensor (shape, strides, dtype; no storage); ``device`` names
    the mesh device through the count's ``DeviceSlots``. Operations on it
    go through ``Counter``."""

    elem: torch.Tensor
    tag: int
    slots: DeviceSlots

    @staticmethod
    def __new__(cls, elem: torch.Tensor, tag: int, slots: DeviceSlots):
        out = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=slots.device(tag), requires_grad=elem.requires_grad)
        out.elem, out.tag, out.slots = elem, tag, slots
        return out

    @property
    def device(self) -> torch.device:
        return self.slots.device(self.tag)

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} on a MeshMeta tensor outside a Counter")

    def __repr__(self) -> str:
        return (f"MeshMeta({tuple(self.shape)}, {self.dtype}, "
                f"device {self.tag})")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Counts the operations run under it on ``MeshMeta`` tensors, device
    by device, over a mesh named by ``slots``. ``counting`` off lays
    tensors out without counting (the arguments). After the run:
    ``flops``, ``bytes``, ``peak`` (high-water mark of the live bytes
    allocated while counting) and ``wire`` ({kind: [copies, bytes
    received]}) a device. An operation runs on the device its ``device=``
    names, else on its first tensor's, else on the last operation's.

    The ``meta`` kernels of many operations are Python (``torch._refs``),
    so an operation that makes new tensors is run once a signature (the
    operation and its arguments' shapes, strides and dtypes) and its
    outputs' shapes reused after; views and in-place operations always
    run. A tensor made while counting is live until its last ``MeshMeta``
    is freed (autograd keeps a saved tensor's)."""

    def __init__(self, slots: DeviceSlots):
        super().__init__()
        n = slots.n
        self.slots = slots
        self.counting = False
        self.flops = [0] * n
        self.bytes = [0] * n
        self.wire = [{k: [0, 0] for k in COLLECTIVES} for _ in range(n)]
        self.live = [0] * n
        self.peak = [0] * n
        self.cross_device_ops = 0
        self._last = 0                # the device of the last operation
        self._shapes: dict = {}       # signature -> the outputs' layouts
        self._holders: dict = {}      # storage -> [live wrappers, bytes, dev]
        self._refs: dict = {}         # weak ref of a wrapper -> its storage

    def wrap(self, t: torch.Tensor, i: int) -> MeshMeta:
        """A plain ``meta`` tensor as one on mesh device ``i``."""
        return MeshMeta(t, i, self.slots)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        devs: list = []
        elems: list = []
        sig: list = [func]

        def unwrap(x):
            if isinstance(x, MeshMeta):
                devs.append(x.tag)
                x = x.elem
            elif isinstance(x, (list, tuple)):
                sig.append(len(x))
                return [unwrap(y) for y in x]
            if isinstance(x, torch.Tensor):
                elems.append(x)
                sig.append((x.shape, x.stride(), x.dtype,
                            x.storage_offset()))
            else:
                sig.append(x)
            return x

        a = [unwrap(x) for x in args]
        k = {}
        for key, v in kwargs.items():
            sig.append(key)
            k[key] = unwrap(v)
        want = k.get("device")
        if want is not None:
            want = torch.device(want)
            if want.type == "meta":
                k["device"] = META
        if want is not None and want.type == "meta" and want.index is not None:
            dev = self.slots.index(want)
        elif devs:
            dev = devs[0]
        else:
            dev = self._last
        self._last = dev
        try:
            key = tuple(sig)
            layout = self._shapes.get(key)
        except TypeError:               # an argument that does not hash
            key = layout = None
        if layout is not None:
            many, kind = layout[0], layout[1]
            made = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device=META)
                    for shape, stride, dtype in layout[2:]]
            out = kind(made) if many else made[0]
            outs, fresh = made, made
        else:
            out = func(*a, **k)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            storages = {e.untyped_storage()._cdata for e in elems}
            fresh = [o for o in outs if isinstance(o, torch.Tensor)
                     and o.untyped_storage()._cdata not in storages]
            if (key is not None and len(fresh) == len(outs)
                    and not func._schema.is_mutable and not func.is_view):
                self._shapes[key] = (
                    isinstance(out, (list, tuple)), type(out),
                    *[(o.shape, o.stride(), o.dtype) for o in outs])
        if self.counting:
            self._count(func, a, k, out, outs, fresh, devs, dev, elems)
        by_elem = {}
        for x in args:
            if isinstance(x, MeshMeta):
                by_elem[id(x.elem)] = x
        wrapped = []
        for o in outs:
            if not isinstance(o, torch.Tensor):
                wrapped.append(o)
            elif id(o) in by_elem:
                wrapped.append(by_elem[id(o)])   # in place: the input itself
            else:
                w = self.wrap(o, dev)
                if self.counting:
                    self._hold(w, o, dev, fresh=any(o is f for f in fresh))
                wrapped.append(w)
        if isinstance(out, (list, tuple)):
            return type(out)(wrapped)
        return wrapped[0]

    def _count(self, func, a, k, out, outs, fresh, devs, dev, elems):
        mutable = func._schema.is_mutable
        if not fresh and not mutable:
            return                        # a view: nothing moves
        in_bytes = sum(_nbytes(e) for e in elems)
        out_bytes = sum(_nbytes(o) for o in outs
                        if isinstance(o, torch.Tensor))
        if func is _TO_COPY and devs and devs[0] != dev:
            # a copy from one device to another
            self.bytes[devs[0]] += in_bytes
            self.bytes[dev] += out_bytes
            w = self.wire[dev][_kind_of_caller()]
            w[0] += 1
            w[1] += in_bytes
        elif func is _TO_COPY and elems[0].dtype == out.dtype:
            pass                          # x.to(its own device): nothing
        else:
            if len(set(devs)) > 1:
                self.cross_device_ops += 1
            fn = flop_registry.get(func._overloadpacket)
            if fn is not None:
                self.flops[dev] += int(fn(*a, **k, out_val=out))
            self.bytes[dev] += in_bytes + out_bytes

    def _hold(self, w: MeshMeta, elem: torch.Tensor, dev: int,
              fresh: bool) -> None:
        """Follow the storage ``w`` holds: new bytes on ``dev`` when it is
        ``fresh``, freed when its last wrapper is."""
        key = elem.untyped_storage()._cdata
        holder = self._holders.get(key)
        if holder is None:
            if not fresh:
                return                    # a view of an argument
            holder = self._holders[key] = [0, elem.untyped_storage().nbytes(),
                                           dev]
            self.live[dev] += holder[1]
            if self.live[dev] > self.peak[dev]:
                self.peak[dev] = self.live[dev]
        holder[0] += 1
        ref = weakref.ref(w, self._release)
        self._refs[ref] = key

    def _release(self, ref) -> None:
        key = self._refs.pop(ref)
        holder = self._holders[key]
        holder[0] -= 1
        if holder[0] == 0:
            del self._holders[key]
            self.live[holder[2]] -= holder[1]


_KIND_OF_CODE: dict = {}


def _kind_of_caller() -> str:
    """The collective a copy between devices stands for, named by the
    innermost caller of ``_KIND_OF_CALLER`` on the stack."""
    frame = sys._getframe(2)
    while frame is not None:
        code = frame.f_code
        kind = _KIND_OF_CODE.get(code)
        if kind is None:
            kind = _KIND_OF_CODE[code] = _KIND_OF_CALLER.get(
                (os.path.basename(code.co_filename), code.co_qualname), "")
        if kind:
            return kind
        frame = frame.f_back
    return "collective-permute"


# ---------------------------------------------------------------------------
# laying the arguments out
# ---------------------------------------------------------------------------

def _block_shape(sharding: NamedSharding, shape, index: int) -> list:
    probe = Sharded([None] * sharding.mesh.size, sharding, shape, None)
    return [b - a for a, b in probe.ranges(index)]


def place(counter: Counter, x: torch.Tensor, sharding=None):
    """A plain ``meta`` tensor laid out per ``sharding`` over the counted
    mesh: a ``Sharded`` of ``MeshMeta`` blocks, one a device (built
    directly, nothing counted), or one ``MeshMeta`` on device 0 without a
    sharding or on a mesh of one device."""
    def meta(shape):
        with _disable_current_modes():
            return torch.empty(shape, dtype=x.dtype, device=META)

    if sharding is None or sharding.mesh.size == 1:
        return counter.wrap(meta(x.shape), 0)
    blocks = [counter.wrap(meta(_block_shape(sharding, x.shape, i)), i)
              for i in range(sharding.mesh.size)]
    return Sharded(blocks, sharding, x.shape, x.dtype)


def _sharded_bytes(shapes, shardings, n: int) -> list:
    """Bytes a device of plain ``meta`` leaves laid out per ``shardings``
    (a tree of ``NamedSharding``s, leaf for leaf; None: on device 0)."""
    out = [0] * n
    sh = tree_leaves(shardings) if shardings is not None else None
    for j, leaf in enumerate(tree_leaves(shapes)):
        size = leaf.element_size()
        s = sh[j] if sh is not None else None
        if s is None or s.mesh.size == 1:
            out[0] += leaf.numel() * size
            continue
        for i in range(n):
            out[i] += math.prod(_block_shape(s, leaf.shape, i)) * size
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _cell_model(arch: str, variant: str, depth: int = 0):
    """(cfg, model) of ``arch`` under ``variant``; ``depth`` > 0 cuts the
    decoder (and the encoder) to that many layers."""
    overrides = dict(VARIANTS[variant])
    serve_params = overrides.pop("_serve_params", False)
    cfg = dataclasses.replace(get_config(arch), **overrides)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth,
                                  enc_layers=depth if cfg.enc_layers else 0)
    model = build_model(cfg)
    model._serve_params = serve_params
    return cfg, model


def count_cell(cfg, model, shape, mesh, microbatches: int = 1) -> dict:
    """Run one cell's entry point on ``MeshMeta`` tensors over ``mesh``
    and count it: {"flops", "bytes", "wire" (per kind), "peak"} a device,
    "cross_device_ops" (operations whose tensors lie on different devices:
    0 where the port's code runs as on a host of that many devices) and
    "seconds"."""
    n = mesh.size
    mesh, slots = counted_mesh(mesh)
    counter = Counter(slots)
    specs = input_specs(cfg, shape)
    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    with counter:
        if shape.kind == "train":
            state = abstract_train_state(model)
            shardings = state_shardings(model, mesh)
            state = map_leaves(lambda x, s: place(counter, x, s), state,
                               shardings)
            if n == 1:      # over a mesh each rank makes its own copy
                state.params.requires_grad_(True)
            batch = {key: place(counter, v) for key, v in specs.items()}
            step = make_train_step(model, AdamWConfig(), mesh,
                                   microbatches=microbatches)

            def run():
                return step(state, batch)
        elif shape.kind == "prefill":
            params = map_leaves(lambda x, s: place(counter, x, s),
                                model.abstract_params(f32),
                                model.param_shardings(mesh))
            tokens = place(counter, specs["tokens"])
            extra = ({"frames": place(counter, specs["frames"])}
                     if "frames" in specs else {})

            def run():
                return model.prefill(params, tokens, mesh, **extra)
        else:
            b, s = shape.global_batch, shape.seq_len
            serve = getattr(model, "_serve_params", False)
            params = map_leaves(
                lambda x, sh: place(counter, x, sh),
                model.abstract_params(bf16 if serve else f32),
                model.param_shardings(
                    mesh, drop_axes=("embed",) if serve else ()))
            cache = model.init_cache(b, s, bf16, device="meta")
            cache = map_leaves(lambda x, sh: place(counter, x, sh), cache,
                               model.cache_shardings(mesh, b, s))
            tokens = place(counter, specs["tokens"])

            def run():
                return model.decode_step(params, tokens, cache, mesh)
        counter.counting = True
        run()
        counter.counting = False
    return {"flops": counter.flops, "bytes": counter.bytes,
            "wire": counter.wire, "peak": counter.peak,
            "cross_device_ops": counter.cross_device_ops,
            "seconds": time.perf_counter() - t0}


def count_function(fn, *args) -> Counter:
    """Count ``fn(*args)`` on one device: ``args`` are trees (``Params``,
    dicts, lists) of tensors, taken by shape and dtype. Returns the
    ``Counter``."""
    slots = DeviceSlots(Mesh([META], ("data",), (1,)))
    counter = Counter(slots)
    with counter:
        placed = [map_leaves(lambda x: place(counter, x), a) for a in args]
        counter.counting = True
        fn(*placed)
        counter.counting = False
    return counter


def _collectives(wire: dict) -> dict:
    out = {k: {"count": c, "wire_bytes": float(b)}
           for k, (c, b) in wire.items()}
    out["total_wire_bytes"] = sum(v["wire_bytes"] for v in out.values())
    return out


def _busiest(values: list) -> int:
    return max(range(len(values)), key=lambda i: (values[i], -i))


def _probe_depth(cfg) -> int:
    return 2 if cfg.family == "ssm" else 1


def _probe_seq_lens(cfg, shape):
    """(S1, S2) to count a cell at instead of its S, or None. The xLSTM
    stack's train and prefill cells have no attention: the mLSTM is a
    chunked scan and the sLSTM a loop over time, so every count grows
    affinely in S given whole chunks, while a count at S itself would walk
    the sLSTM loop 32,768 times a rank; they are counted at 1 and 2
    chunks."""
    if cfg.family != "ssm" or shape.kind == "decode":
        return None
    q = cfg.xlstm_config().chunk
    return q, 2 * q


def _affine(lo: dict, hi: dict, x0, x1, x) -> dict:
    """Each device's FLOPs, bytes and wire (kind by kind) of two counts,
    at x0 and x1, taken affinely to x."""
    def at(a, b):
        return a + (x - x0) / (x1 - x0) * (b - a)

    return {
        "flops": [at(a, b) for a, b in zip(lo["flops"], hi["flops"])],
        "bytes": [at(a, b) for a, b in zip(lo["bytes"], hi["bytes"])],
        "wire": [{kind: [at(wl[kind][0], wh[kind][0]),
                         at(wl[kind][1], wh[kind][1])]
                  for kind in COLLECTIVES}
                 for wl, wh in zip(lo["wire"], hi["wire"])],
        "cross_device_ops": lo["cross_device_ops"] + hi["cross_device_ops"],
        "seconds": lo["seconds"] + hi["seconds"]}


def extrapolate_depth(arch: str, variant: str, shape, mesh,
                      microbatches: int) -> dict:
    """Counts at depths k and 2k (k = 2 for the xLSTM stack, whose layers
    alternate, else 1) and each device's FLOPs, bytes and wire bytes (kind
    by kind) extrapolated linearly to the arch's depth: m(L) = m(k) + (L -
    k) / k (m(2k) - m(k)), the JAX package's ``extrapolate_depth``; at
    each depth, a cell of ``_probe_seq_lens`` is counted at two lengths and
    taken affinely to its own."""
    cfg = get_config(arch)
    k = _probe_depth(cfg)
    seqs = _probe_seq_lens(cfg, shape)

    def at_depth(depth):
        c_cfg, c_model = _cell_model(arch, variant, depth)
        if seqs is None:
            return count_cell(c_cfg, c_model, shape, mesh, microbatches)
        lo, hi = (count_cell(c_cfg, c_model,
                             dataclasses.replace(shape, seq_len=s), mesh,
                             microbatches) for s in seqs)
        return _affine(lo, hi, *seqs, shape.seq_len)

    out = _affine(at_depth(k), at_depth(2 * k), k, 2 * k, cfg.n_layers)
    for w in out["wire"]:
        for kind in COLLECTIVES:
            w[kind][0] = round(w[kind][0])
    out["probe_depths"] = [k, 2 * k]
    if seqs is not None:
        out["probe_seq_lens"] = list(seqs)
    return out


def _full_memory(cfg, model, shape, mesh) -> tuple:
    """(arguments, outputs) bytes a device of the cell, from its shardings:
    a train step's state and batch (the batch on device 0, where the port
    holds it) and its state; a prefill's parameters and tokens, its logits
    (float32, on device 0) and its caches; a decode step's parameters,
    tokens and cache, its logits and cache."""
    n = mesh.size
    specs = input_specs(cfg, shape)
    f32, bf16 = torch.float32, torch.bfloat16
    batch = _sharded_bytes(specs, None, n)
    if shape.kind == "train":
        state = _sharded_bytes(abstract_train_state(model),
                               state_shardings(model, mesh), n)
        args = [a + b for a, b in zip(state, batch)]
        return args, list(state)
    b, s = shape.global_batch, shape.seq_len
    vocab = cfg.vocab
    logits = [b * vocab * 4 if i == 0 else 0 for i in range(n)]
    if shape.kind == "prefill":
        params = _sharded_bytes(model.abstract_params(f32),
                                model.param_shardings(mesh), n)
        cache = model.init_cache(b, s, bf16, device="meta")
        cache_b = _sharded_bytes(cache, model.cache_shardings(mesh, b, s), n)
        return ([p + t for p, t in zip(params, batch)],
                [x + y for x, y in zip(logits, cache_b)])
    serve = getattr(model, "_serve_params", False)
    params = _sharded_bytes(
        model.abstract_params(bf16 if serve else f32),
        model.param_shardings(mesh, drop_axes=("embed",) if serve else ()),
        n)
    cache = model.init_cache(b, s, bf16, device="meta")
    cache_b = _sharded_bytes(cache, model.cache_shardings(mesh, b, s), n)
    return ([p + t + c for p, t, c in zip(params, batch, cache_b)],
            [x + y for x, y in zip(logits, cache_b)])


def lower_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True,
               probes: bool = True, variant: str = "baseline") -> dict:
    """The record of one cell: the JAX package's ``lower_cell`` keys, the
    port's counts. ``lower_s`` is the count's seconds, laying the
    arguments out included; ``compile_s`` is 0 (nothing is compiled)."""
    cfg, model = _cell_model(arch, variant)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": reason}
    n = mesh.size
    mb = TRAIN_MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1
    t0 = time.perf_counter()
    args, outs = _full_memory(cfg, model, shape, mesh)
    memory = {"argument_size_in_bytes": max(args),
              "output_size_in_bytes": max(outs)}
    if probes:
        c = extrapolate_depth(arch, variant, shape, mesh, mb)
        extrap = {key: c[key] for key in ("probe_depths", "probe_seq_lens")
                  if key in c}
    else:
        c = count_cell(cfg, model, shape, mesh, mb)
        memory["temp_size_in_bytes"] = max(c["peak"])
        extrap = {}
    count_s = time.perf_counter() - t0
    wire_total = [sum(b for _, b in w.values()) for w in c["wire"]]
    busy_f, busy_b = _busiest(c["flops"]), _busiest(c["bytes"])
    busy_w = _busiest(wire_total)
    if probes:
        extrap.update(flops=float(c["flops"][busy_f]),
                      bytes=float(c["bytes"][busy_b]),
                      wire_bytes=float(wire_total[busy_w]))
    extrap["variant"] = variant
    result = {
        "variant": variant,
        "arch": arch, "shape": shape_name, "status": "ok",
        "mesh": list(mesh.shape), "axis_names": list(mesh.axis_names),
        "n_devices": int(n),
        "n_params": model.n_params(),
        "n_active_params": model.n_active_params(),
        "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "microbatches": mb,
        "lower_s": round(count_s, 2), "compile_s": 0.0,
        "memory": memory,
        "cost": {"flops": float(c["flops"][busy_f]),
                 "bytes accessed": float(c["bytes"][busy_b])},
        "collectives": _collectives(c["wire"][busy_w]),
        "cost_sum_over_devices": {
            "flops": float(sum(c["flops"])),
            "bytes accessed": float(sum(c["bytes"])),
            "wire_bytes": float(sum(wire_total))},
        "busiest_device": {"flops": busy_f, "bytes": busy_b,
                           "wire": busy_w},
        "devices_computing": sum(1 for f in c["flops"] if f > 0),
        "cross_device_ops": c["cross_device_ops"],
        "extrapolated": extrap,
    }
    if verbose:
        wire = result["collectives"]["total_wire_bytes"]
        print(f"  {arch} × {shape_name} [{'x'.join(map(str, mesh.shape))}]"
              f" OK count={count_s:.1f}s"
              f" flops/dev={result['cost']['flops']:.3g}"
              f" wire/dev={wire / 2**30:.3f}GiB", flush=True)
    return result


def _write_cell(arch: str, shape: str, mesh_name: str, variant: str,
                out: str) -> bool:
    """Count one cell on its mesh and write its record; True if ok (or
    skipped)."""
    mesh = make_production_mesh(multi_pod=mesh_name == "multi_pod",
                                device="meta")
    suffix = "" if variant == "baseline" else f"_{variant}"
    path = os.path.join(out, f"{arch}_{shape}_{mesh_name}{suffix}.json")
    try:
        res = lower_cell(arch, shape, mesh, variant=variant)
    except Exception as e:
        res = {"arch": arch, "shape": shape, "status": "error",
               "mesh": mesh_name, "error": str(e),
               "traceback": traceback.format_exc()}
        print(f"  {arch} × {shape} [{mesh_name}] FAILED: {e}", flush=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    return res["status"] != "error"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at once, one process each")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = []
    if not args.multi_pod_only:
        meshes.append("single_pod")
    if not args.single_pod_only:
        meshes.append("multi_pod")
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    # the longest counts first (train steps, then the larger mesh), so that
    # --jobs processes finish together
    cells = sorted(((arch, shape, m, args.variant, args.out)
                    for m in meshes for arch in archs for shape in shapes),
                   key=lambda c: (SHAPES[c[1]].kind != "train",
                                  c[2] != "multi_pod"))
    print(f"=== {len(cells)} cells over {', '.join(meshes)}, "
          f"{args.jobs} at once", flush=True)
    if args.jobs > 1:
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(args.jobs) as pool:
            results = list(pool.map(_write_cell, *zip(*cells)))
    else:
        results = [_write_cell(*cell) for cell in cells]
    failures = results.count(False)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
