"""Pipeline parallelism: GPipe microbatch streaming over a ``stage`` mesh
axis, the JAX package's ``train/pipeline.py``.

The layer stack is split into ``n_stages`` contiguous chunks, stage s's on
its devices; microbatches stream through the stages: at tick t stage s
applies its chunk to microbatch t - s (the JAX package's scan also runs
the bubble ticks, whose results it discards; here they are skipped) and
hands its activation to stage s + 1 (the ``ppermute``, a copy to the next
stage's device). The last stage's outputs are broadcast to every stage
(the ``psum`` of the masked outputs): the result is returned on the mesh's
first device. Over a ``data`` axis each data rank streams its rows of
every microbatch through its own stages. The whole is differentiable:
autograd takes the copies back through the stages.

Bubble fraction = (S - 1) / (M + S - 1); choose M >> S.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.spec import map_leaves, tree_leaves


def _chunk(params, stage: int, n_stages: int, device):
    """Stage ``stage``'s layers [L/S s, L/S (s + 1)) of a stacked tree, on
    ``device``."""
    n = tree_leaves(params)[0].shape[0] // n_stages
    return map_leaves(lambda a: a[stage * n:(stage + 1) * n].to(device),
                      params)


def make_pipeline_forward(stage_fn: Callable, n_stages: int, mesh,
                          data_axis: str | None = "data"):
    """Build a pipelined forward over a stacked-parameter layer stack.

    stage_fn(params_chunk, x) -> x applies one stage's layer chunk
    (params_chunk: an [L/S, ...] slice of each leaf; x: [mb, ...]).
    Returns pipeline(params, x_mb) with params a tree of stacked [L, ...]
    tensors and x_mb [M, mb, ...] microbatches; output [M, mb, ...] on the
    mesh's first device. ``mesh`` has a ``stage`` axis of ``n_stages``
    devices; ``data_axis``, when the mesh has it, splits each microbatch's
    rows (mb) over its devices."""
    if mesh.axis_size("stage") != n_stages:
        raise ValueError(f"the mesh's stage axis has "
                         f"{mesh.axis_size('stage')} devices, not {n_stages}")
    n_data = (mesh.axis_size(data_axis)
              if data_axis and data_axis in mesh.axis_names else 1)

    def pipeline(params, x_mb):
        m, mb = x_mb.shape[0], x_mb.shape[1]
        if mb % n_data:
            raise ValueError(f"microbatch rows {mb} do not divide over the "
                             f"{n_data} devices of {data_axis!r}")
        rows = mb // n_data
        home = mesh.devices[0]
        out_rows = []
        for d in range(n_data):
            coords = {data_axis: d} if n_data > 1 else {}
            devices = [mesh.devices[mesh.index(stage=s, **coords)]
                       for s in range(n_stages)]
            chunks = [_chunk(params, s, n_stages, dev)
                      for s, dev in enumerate(devices)]
            outputs = [None] * m
            recv = [None] * n_stages          # what stage s received
            for t in range(m + n_stages - 1):
                sent = [None] * n_stages
                for s in range(n_stages):
                    mb_idx = t - s
                    if not 0 <= mb_idx < m:
                        continue              # a bubble tick
                    xin = (x_mb[mb_idx, d * rows:(d + 1) * rows].to(
                        devices[0]) if s == 0 else recv[s])
                    y = stage_fn(chunks[s], xin)
                    if s == n_stages - 1:
                        outputs[mb_idx] = y.to(home)
                    else:
                        sent[s + 1] = y.to(devices[s + 1])   # the ppermute
                recv = sent
            out_rows.append(torch.stack(outputs))
        return torch.cat(out_rows, dim=1)

    return pipeline


def sequential_reference(stage_fn: Callable, n_stages: int, params, x_mb):
    """Ground truth: every stage applied in turn to each microbatch."""
    def apply_all(x):
        l = tree_leaves(params)[0].shape[0]
        chunk = l // n_stages
        for si in range(n_stages):
            p = map_leaves(lambda a: a[si * chunk:(si + 1) * chunk], params)
            x = stage_fn(p, x)
        return x
    return torch.stack([apply_all(x_mb[i]) for i in range(x_mb.shape[0])])
