"""Where the port's entry points run, and the devices a mesh spans.

A mesh here is one process driving an explicit tuple of devices (the
counterpart of a 1-d ``jax.sharding.Mesh``, whose single controller drives
every device), not ``torch.distributed``'s one process a rank.
``REPRO_TORCH_DEVICE_COUNT=N`` plays the part of XLA's
``--xla_force_host_platform_device_count=N``: when it asks for more devices
than the host has, ``visible_devices`` returns N *logical* devices placed
round-robin on the physical ones (``[cpu] * 8`` on the CPU, ``[cuda:0] * 4``
on one card). A shard on a logical device holds tensors of its own, so the
code is the code a host with that many cards runs; what one card cannot
show is the cost of copies between cards.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch

#: the environment variable that asks for logical devices
DEVICE_COUNT_VAR = "REPRO_TORCH_DEVICE_COUNT"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is visible: nothing drops to the CPU
    unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch lanes on the CPU")
    return device


def canonical_device(device) -> torch.device:
    """``resolve_device`` with a card's index filled in (``cuda`` is the
    current card), so that two names of one device compare equal."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def visible_devices(kind="cuda") -> list:
    """The devices of ``kind`` (``"cuda"`` or ``"cpu"``, or a device of that
    type) that a mesh or a split batch may span: the host's cards, or the
    one CPU device. ``REPRO_TORCH_DEVICE_COUNT=N``, read at each call, asks
    for N devices: more than the host has gives N logical devices placed
    round-robin on the physical ones; N at most the host's count changes
    nothing."""
    kind = resolve_device(kind).type
    if kind == "cuda":
        physical = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        physical = [torch.device("cpu")]
    else:
        raise ValueError(f"no mesh of {kind!r} devices")
    raw = os.environ.get(DEVICE_COUNT_VAR, "").strip()
    if not raw:
        return physical
    try:
        n = int(raw)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(f"{DEVICE_COUNT_VAR}={raw!r} must be a positive "
                         "integer")
    if n <= len(physical):
        return physical
    return [physical[i % len(physical)] for i in range(n)]


class _MeshFields(NamedTuple):
    devices: tuple
    axis_names: tuple
    shape: tuple


class Mesh(_MeshFields):
    """A device mesh: ``devices`` in row-major mesh order (a device may
    repeat: logical devices on one physical one), one name a mesh axis and
    the axes' sizes ``shape`` (``(len(devices),)`` for one axis; with more
    names and no shape, the last axis takes every device, as the JAX
    package's ``make_host_mesh`` does). The counterpart of
    ``jax.sharding.Mesh``: nothing is allocated, so a mesh of ``[cpu] *
    256`` costs a tuple."""

    def __new__(cls, devices, axis_names, shape=None):
        devices, axis_names = tuple(devices), tuple(axis_names)
        if shape is None:
            shape = (1,) * (len(axis_names) - 1) + (len(devices),)
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names) or math.prod(shape) != len(devices):
            raise ValueError(f"a mesh of shape {shape} over axes "
                             f"{axis_names} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        return super().__new__(cls, devices, axis_names, shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 for an axis the mesh does not have."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def coords(self, index: int) -> dict:
        """{axis: coordinate} of the device at ``index`` (row-major)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            index, out[name] = divmod(index, n)
        return out

    def index(self, **coords) -> int:
        """The row-major index of the device at ``coords`` (an axis left
        out is at 0)."""
        i = 0
        for name, n in zip(self.axis_names, self.shape):
            c = coords.get(name, 0)
            if not 0 <= c < n:
                raise ValueError(f"coordinate {name}={c} outside 0..{n - 1}")
            i = i * n + c
        return i
