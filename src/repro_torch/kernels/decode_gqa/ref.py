"""Plain PyTorch version of the GQA decode kernel (``csrc/``).

The CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on
the card; nothing on the card's path calls it. It follows the kernel's
arithmetic, which is the TPU kernel's: float32 logits scaled by 1/sqrt(Dh)
after the dot, keys at or past the row's length masked, p = exp(s - max),
output (p @ v) / max(sum p, 1e-30). A row of length 0 gives zeros, as the
TPU kernel does; the JAX package's ``decode_gqa_ref`` gives the mean of v
there.
"""
from __future__ import annotations

import math

import torch


def decode_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Dh]; k/v: [B, S, KVH, Dh]; lengths: [B] valid keys per row.
    Returns [B, H, Dh] float32."""
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kvh, h // kvh, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (
        1.0 / math.sqrt(dh))
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.reshape(b, 1))[:, None, None, :]   # [B, 1, 1, S]
    logits = torch.where(valid, logits, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, dh)
