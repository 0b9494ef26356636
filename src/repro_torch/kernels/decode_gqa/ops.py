"""Entry point of the GQA decode kernel, with the JAX package's
``ops.decode_gqa`` contract: q [B, H, Dh], k/v [B, S, KVH, Dh], ``length`` a
scalar or [B] -> [B, H, Dh] float32.

The JAX wrapper moves the cache to [B, KVH, S, Dh] and pads S to its block;
the CUDA kernel reads the cache in place and masks by length, so this
wrapper copies nothing but the lengths. A length of 0 gives zeros (the
TPU kernel's behaviour). ``return_lse`` adds each head's log-sum-exp over
its valid keys, [B, H] float32, from the same launch.
"""
from __future__ import annotations

import torch

from .kernel import decode_gqa_bshd


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length, return_lse: bool = False):
    """q: [B, H, Dh]; k/v: [B, S, KVH, Dh]; length: scalar or [B].
    Returns [B, H, Dh] float32 (and [B, H] float32 with ``return_lse``)."""
    b = q.shape[0]
    lengths = torch.as_tensor(length, device=q.device).to(torch.int32)
    return decode_gqa_bshd(q, k, v, lengths.reshape(-1).expand(b),
                           return_lse)
