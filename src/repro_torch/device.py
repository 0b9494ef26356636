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


class Mesh(NamedTuple):
    """A 1-d device mesh: ``devices`` in mesh order (a device may repeat:
    logical devices on one physical one) and one axis name."""

    devices: tuple
    axis_names: tuple
