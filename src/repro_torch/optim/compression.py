"""Gradient compression with error feedback, the JAX package's
``optim/compression.py``: a blockwise symmetric int8 quantize -> dequantize
round trip (the wire format an all-reduce would carry), with the
quantization error carried to the next step in an error-feedback buffer so
that the noise does not bias training (Karimireddy et al., 2019).

``torch.round`` rounds half to even, as ``jnp.round`` does, and the block
scale divides by a tensor (see ``adamw``), so the round trip equals the
reference's bit for bit on the CPU.

The 256-element blocks run over a leaf's whole flat order, and a block of a
leaf split on a later dim is not contiguous in it: a ``spec.Sharded``
gradient is quantized whole, in the global order (gathered, then laid out
again as it was, with its error feedback).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..models.spec import Sharded, gather, put, tree_leaves

BLOCK = 256


class ErrorFeedback(NamedTuple):
    residual: list          # float32, one a gradient leaf


def init_error_feedback(params: Any) -> ErrorFeedback:
    return ErrorFeedback(residual=[
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in tree_leaves(params)])


def _quantize_dequantize(g: torch.Tensor) -> torch.Tensor:
    """Blockwise symmetric int8 quantize -> dequantize of ``g`` (blocks of
    ``BLOCK`` over the flattened tensor, the last one zero-padded)."""
    flat = g.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.shape[0]) % BLOCK)).reshape(-1, BLOCK)
    scale = (blocks.abs().amax(dim=1, keepdim=True)
             / torch.tensor(127.0, dtype=blocks.dtype, device=g.device)
             + 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.reshape(-1)[: g.numel()].reshape(g.shape)


def compress_with_feedback(grads: Any, ef: ErrorFeedback
                           ) -> tuple[list, ErrorFeedback]:
    """grads + residual -> int8 round trip; the new residual is the
    quantization error. ``Sharded`` leaves come back in their layouts."""
    compressed, residual = [], []
    for g, r in zip(tree_leaves(grads), ef.residual):
        whole = gather(g).to(torch.float32)
        c = whole + gather(r, whole.device)
        q = _quantize_dequantize(c)
        compressed.append(put(q, g.sharding) if isinstance(g, Sharded)
                          else q)
        residual.append(put(c - q, r.sharding) if isinstance(r, Sharded)
                        else c - q)
    return compressed, ErrorFeedback(residual=residual)
