"""Entry point of the flash-attention kernel, with the JAX package's
``ops.flash_attention`` contract: q [B, Sq, H, Dh], k/v [B, Sk, KVH, Dh] ->
[B, Sq, H, Dh] in q's dtype.

The JAX wrapper transposes to [B, H, S, Dh] and pads S to its block size;
the CUDA kernel reads the [B, S, H, Dh] layout through strides and masks the
ragged edge itself, so this wrapper copies nothing. It keeps the JAX
wrapper's one refusal, so that both accept the same inputs: non-causal
attention over a key length that is not a multiple of the TPU block (128 up
to 128 keys, else 256).
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_bshd

TPU_BK = 256   # the JAX kernel's DEFAULT_BK


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh] -> [B, Sq, H, Dh]."""
    sk = k.shape[1]
    bk = 128 if sk <= 128 else TPU_BK
    if sk % bk and not causal:
        raise ValueError("non-causal flash path requires Sk % bk == 0")
    return flash_attention_bshd(q, k, v, causal=causal, window=window)
