"""Step-atomic, async checkpoints, the JAX package's
``checkpoint/checkpointer.py``, in its on-disk layout:

    <dir>/step_<n>/
        manifest.json     # step, treedef, n_leaves, n_shards, shapes, dtypes
        shard_<k>.npz     # leaf_<i> arrays, a shard closed at 512 MiB
    <dir>/LATEST          # atomic pointer (written last)

* **step-atomic**: shards go to ``step_<n>.tmp``, the manifest last, then
  a rename and an atomic ``LATEST``: a crash mid-save never corrupts the
  previous checkpoint.
* **async**: ``AsyncCheckpointer.save_async`` copies the leaves to host
  memory and writes them on a background thread while training goes on.
* **leaf order**: ``jax.tree.flatten``'s. Dict (and ``Params``) keys
  sorted, lists, tuples and NamedTuples in order, ``None`` no leaf; a
  tensor, a numpy array or a Python number is a leaf. So a plain tree (the
  same nested dicts, lists and NamedTuples of arrays) written by either
  package restores in the other. A train state does not cross: the JAX
  package stacks a homogeneous model's layers on a leading axis, the port
  keeps a list (``bridge.train_state_to_numpy`` maps one onto the other).

``restore`` puts the leaves on ``device``, or, given ``shardings`` (a tree
of ``spec.NamedSharding``s leaf for leaf), lays each out over its mesh
(``spec.put``): the reference's resharding path onto another mesh
(``runtime.elastic``). A ``spec.Sharded`` leaf is saved whole, so a
checkpoint does not depend on the mesh it was written from.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.spec import LEAF_TYPES, Params, Sharded, put, tree_leaves

_MAX_SHARD_BYTES = 512 * 1024 * 1024


def _treedef(tree: Any) -> str:
    """The tree's structure, for the manifest (nothing reads it back)."""
    if isinstance(tree, LEAF_TYPES):
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, (dict, Params)):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}"
                               for k in sorted(tree.keys())) + "}"
    inner = ", ".join(_treedef(c) for c in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}({inner})"
    return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array of its own (never a view of the tensor); a
    ``Sharded`` leaf whole."""
    if isinstance(x, Sharded):
        x = x.gather("cpu")
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            import ml_dtypes
            return x.to(torch.float32).cpu().numpy().astype(
                ml_dtypes.bfloat16)
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _from_host(a: np.ndarray) -> torch.Tensor:
    """A loaded array as a tensor (sharing its memory); numpy's
    ``ml_dtypes`` bfloat16 exactly."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _write(directory: str, step: int, host: list, treedef: str) -> str:
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    shards, cur, cur_bytes, idx = [], {}, 0, 0
    for i, arr in enumerate(host):
        cur[f"leaf_{i}"] = arr
        cur_bytes += arr.nbytes
        if cur_bytes >= _MAX_SHARD_BYTES:
            np.savez(os.path.join(tmp, f"shard_{idx}.npz"), **cur)
            shards.append(len(cur))
            cur, cur_bytes, idx = {}, 0, idx + 1
    if cur:
        np.savez(os.path.join(tmp, f"shard_{idx}.npz"), **cur)
        shards.append(len(cur))

    manifest = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(host),
        "n_shards": len(shards),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def save(directory: str, step: int, tree: Any) -> str:
    """Synchronous step-atomic save. Returns the checkpoint path."""
    return _write(directory, step, [_to_host(x) for x in tree_leaves(tree)],
                  _treedef(tree))


class AsyncCheckpointer:
    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        self.wait()
        # snapshot to host synchronously (cheap vs device compute), write async
        host = [_to_host(x) for x in tree_leaves(tree)]
        treedef = _treedef(tree)

        def _write_snapshot():
            try:
                _write(self.directory, step, host, treedef)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_write_snapshot, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def latest_step(directory: str) -> Optional[int]:
    path = os.path.join(directory, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip())


def _unflatten(target: Any, leaves) -> Any:
    """``target``'s structure with the next of ``leaves`` at each leaf; a
    ``Params`` leaf keeps the target's ``requires_grad``."""
    if isinstance(target, LEAF_TYPES):
        t = next(leaves)
        if isinstance(target, nn.Parameter) and not isinstance(t, Sharded):
            return nn.Parameter(t, requires_grad=target.requires_grad)
        return t
    if target is None:
        return None
    if isinstance(target, Params):
        return Params({k: _unflatten(target[k], leaves)
                       for k in sorted(target.keys())})
    if isinstance(target, dict):
        return {k: _unflatten(target[k], leaves) for k in sorted(target)}
    if isinstance(target, nn.ModuleList):
        return nn.ModuleList(_unflatten(c, leaves) for c in target)
    children = [_unflatten(c, leaves) for c in target]
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*children)
    return type(target)(children)


def restore(directory: str, step: int, target_tree: Any,
            shardings: Any = None, device="cuda") -> Any:
    """Restore into the structure of ``target_tree`` (real or ``meta``
    tensors), every leaf a tensor on ``device`` (the card unless the caller
    passes ``"cpu"``), or laid out per ``shardings`` (same structure; then
    ``device`` is not read)."""
    if shardings is not None:
        placements = tree_leaves(shardings)
        device = "cpu"
    else:
        device = resolve_device(device)
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n_target = len(tree_leaves(target_tree))
    if n_target != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target {n_target}")
    if shardings is not None and len(placements) != n_target:
        raise ValueError(f"{len(placements)} shardings for {n_target} "
                         "leaves")
    leaves = [None] * manifest["n_leaves"]
    for k in range(manifest["n_shards"]):   # a shard at a time in memory
        with np.load(os.path.join(path, f"shard_{k}.npz")) as z:
            for name in z.files:
                i = int(name.split("_")[1])
                leaves[i] = _from_host(z[name]).to(device)
                if shardings is not None:
                    leaves[i] = put(leaves[i], placements[i])
    return _unflatten(target_tree, iter(leaves))
