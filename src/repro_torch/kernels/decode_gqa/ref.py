"""Plain PyTorch version of the GQA decode kernel (``csrc/``).

The CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on
the card; nothing on the card's path calls it. It follows the kernel's
arithmetic, which is the TPU kernel's: float32 logits scaled by 1/sqrt(Dh)
after the dot, keys at or past the row's length masked, p = exp(s - max),
output (p @ v) / max(sum p, 1e-30). A row of length 0 gives zeros, as the
TPU kernel does; the JAX package's ``decode_gqa_ref`` gives the mean of v
there.

``decode_gqa_split_ref`` follows the kernel's partition as well: each of
``n_splits`` splits takes its contiguous share of the valid keys (rounded up
to the kernel's key tile, ``key_tile``), computes its own (m, l, acc), and
the splits are combined in rank order, as the kernel's cluster combines its
CTAs through distributed shared memory.
"""
from __future__ import annotations

import math

import torch

# the kernel's key tile (``key_tile`` in csrc/decode_gqa.cu): warps a CTA,
# 16-byte K loads a lane issues at once
WARPS, UNROLL = 4, 4


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


def key_tile(elem_bytes: int, head_dim: int) -> int:
    """Keys one CTA of the kernel covers a step of its loop: a split's share
    of the valid range is a multiple of it. A row's 16-byte pieces are
    spread over the lanes of a key (a power of two from 8 to 32); past 32
    pieces a lane holds two, and takes half as many keys a step."""
    chunks = head_dim * elem_bytes // 16
    lanes = 8
    while lanes < min(chunks, 32):
        lanes *= 2
    nv = -(-chunks // lanes)
    return WARPS * (32 // lanes) * (UNROLL // nv)


def split_bounds(length: int, n_splits: int, tile: int) -> list:
    """[begin, end) of each split's share of the valid keys [0, length):
    ceil(length / n_splits) rounded up to ``tile``, in rank order; the last
    shares may be empty."""
    per = -(-(-(-length // n_splits)) // tile) * tile
    bounds = []
    for rank in range(n_splits):
        begin = min(rank * per, length)
        bounds.append((begin, min(begin + per, length)))
    return bounds


def decode_gqa_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, n_splits: int = 8,
                         tile: int | None = None) -> torch.Tensor:
    """``decode_gqa_ref`` computed as the kernel partitions it: each split's
    running max m, sum l and unnormalised acc over its share of the valid
    keys (m = -1e30, l = 0, acc = 0 for an empty share), then the splits
    combined in rank order: m = max m_r, l = sum l_r exp(m_r - m),
    out = sum acc_r exp(m_r - m) / max(l, 1e-30). ``tile`` defaults to the
    kernel's key tile for k's dtype and head_dim."""
    b, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if tile is None:
        tile = key_tile(k.element_size(), dh)
    scale, dev = 1.0 / math.sqrt(dh), q.device
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    for row in range(b):
        length = int(min(max(int(lengths[row]), 0), k.shape[1]))
        qg = q[row].float().reshape(kvh, g, dh)
        ms, ls, accs = [], [], []
        for begin, end in split_bounds(length, n_splits, tile):
            if begin == end:
                ms.append(torch.full((kvh, g, 1), -1e30, device=dev))
                ls.append(torch.zeros((kvh, g, 1), device=dev))
                accs.append(torch.zeros((kvh, g, dh), device=dev))
                continue
            s = torch.einsum("hgd,shd->hgs", qg,
                             k[row, begin:end].float()) * scale
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            ms.append(m)
            ls.append(p.sum(dim=-1, keepdim=True))
            accs.append(torch.einsum("hgs,shd->hgd", p,
                                     v[row, begin:end].float()))
        m = torch.stack(ms).amax(dim=0)
        lsum = torch.zeros_like(m)
        acc = torch.zeros((kvh, g, dh), device=dev)
        for m_r, l_r, acc_r in zip(ms, ls, accs):
            c = torch.exp(m_r - m)
            lsum = lsum + l_r * c
            acc = acc + acc_r * c
        out[row] = (acc / lsum.clamp_min(1e-30)).reshape(h, dh)
    return out
