"""Entry point of the GQA decode kernel, with the JAX package's
``ops.decode_gqa`` contract: q [B, H, Dh], k/v [B, S, KVH, Dh], ``length`` a
scalar or [B] -> [B, H, Dh] float32.

The JAX wrapper moves the cache to [B, KVH, S, Dh] and pads S to its block;
the CUDA kernel reads the cache in place and masks by length, so this
wrapper copies nothing but the lengths. A length of 0 gives zeros (the
TPU kernel's behaviour).
"""
from __future__ import annotations

import torch

from .kernel import decode_gqa_bshd


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length) -> torch.Tensor:
    """q: [B, H, Dh]; k/v: [B, S, KVH, Dh]; length: scalar or [B].
    Returns [B, H, Dh] float32."""
    b = q.shape[0]
    lengths = torch.as_tensor(length, device=q.device).to(torch.int32)
    return decode_gqa_bshd(q, k, v, lengths.reshape(-1).expand(b))
