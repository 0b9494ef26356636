"""Meshes of the LM scaffold: the host's devices, and the production
shapes.

Single pod: 256 chips as (data=16, model=16). Multi-pod: 2 pods = 512 chips
as (pod=2, data=16, model=16); the leading ``pod`` axis carries pure data
parallelism, ``model`` (tensor and expert parallel) stays inside a pod.
The JAX package's ``launch/mesh.py`` shapes and names; the port's mesh is a
``device.Mesh``, one process driving a tuple of devices.

Functions only: importing this module touches no device.
"""
from __future__ import annotations

import torch

from ..device import DEVICE_COUNT_VAR, Mesh, canonical_device, visible_devices


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with ``multi_pod``, on the visible devices of ``device``'s
    kind; raises when fewer are visible. ``device="meta"`` repeats the
    shape-only device, any number of which cost nothing (the dry run's
    mesh)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if torch.device(device).type == "meta":
        return Mesh([torch.device("meta")] * n, axes, shape)
    devices = visible_devices(device)
    if len(devices) < n:
        raise ValueError(
            f"the production mesh {shape} needs {n} devices, "
            f"{len(devices)} visible; export {DEVICE_COUNT_VAR}={n} for "
            "that many logical devices")
    return Mesh([canonical_device(d) for d in devices[:n]], axes, shape)


def make_host_mesh(device="cuda") -> Mesh:
    """(1, n) over ("data", "model"): every visible device of ``device``'s
    kind (the card unless the caller passes ``"cpu"``; n logical devices
    under ``REPRO_TORCH_DEVICE_COUNT=n``) on the model axis, as the JAX
    package's ``make_host_mesh`` puts the host's devices."""
    devices = [canonical_device(d) for d in visible_devices(device)]
    return Mesh(devices, ("data", "model"), (1, len(devices)))
