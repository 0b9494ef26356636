"""Plain PyTorch version of the flash-attention kernel (``csrc/``).

The CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on
the card; nothing on the card's path calls it. It follows the kernel's
arithmetic, which is the TPU kernel's: float32 logits scaled by 1/sqrt(Dh)
after the dot, masked logits -1e30, p = mask ? exp(s - max) : 0, output
(p @ v) / max(sum p, 1e-30). Where a query sees at least one key this is
the JAX package's ``attention_ref``; a query that sees none gives zeros
here (and in both kernels) where ``attention_ref`` gives the mean of v.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, causal: bool, window: int, device):
    """[Sq, Sk] bool: key k is visible to query q."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _top_bf16(x: torch.Tensor) -> torch.Tensor:
    """The top 16 bits of float32 x, as float32: a bf16 value (truncated)."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def split3(p: torch.Tensor):
    """The bf16 kernel's split of float32 p into three bf16 terms, as its
    ``split3`` does it: keep the top 16 bits (a bf16, truncated), take the
    remainder in float32 (exact), repeat. The second remainder has at most
    8 significant bits, so hi + mid + lo is p exactly, and P.V run as three
    bf16 products keeps p in float32."""
    hi = _top_bf16(p)
    rest = p - hi
    mid = _top_bf16(rest)
    lo = _top_bf16(rest - mid)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        p_dtype: torch.dtype | None = None) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh] -> [B, Sq, H, Dh], q's dtype.

    ``p_dtype`` rounds p to that type before P.V, as a kernel that fed the
    tensor cores a single bf16 p would. The kernels keep p in float32; the
    checks use this option to show that they do."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(dh))
    mask = attention_mask(sq, sk, causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1).clamp_min(1e-30)                 # [B, KVH, G, Sq]
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out / denom.permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)
