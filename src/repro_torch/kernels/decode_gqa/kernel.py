"""Launcher of the GQA decode CUDA kernel (``csrc/decode_gqa.cu``).

``decode_gqa_bshd(q, k, v, lengths)`` takes one query per row q [B, H, Dh],
a KV cache k/v [B, S, KVH, Dh] and the valid keys per row ``lengths`` [B]
int32, and returns [B, H, Dh] float32. q and the cache may each be float32
or bfloat16. On CPU tensors it returns the plain PyTorch version of
``ref.py``; on CUDA tensors it launches the kernel once on the current
stream, as clusters of ``N_SPLITS`` = 8 CTAs, or raises. The
cache is read in its layout through strides (the head_dim stride must be
1); its 16-byte copies need 16-byte-aligned base addresses and row
strides, which the launcher checks and refuses rather than copy. Only the
output is allocated. With ``return_lse`` the same launch also stores each
head's log-sum-exp over its valid keys ([B, H] float32, -inf at length 0),
which a sequence-sharded cache's combine needs. ``LAUNCHES`` counts the
calls that launched the kernel, ``"decode_gqa_lse"`` those of the
log-sum-exp form (the plain version adds nothing).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import load_library, raise_on_error
from .ref import decode_gqa_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_gqa.cu"

LAUNCHES = {"decode_gqa": 0, "decode_gqa_lse": 0}

MAX_HEAD_DIM = 256
N_SPLITS = 8        # CTAs a cluster (kSplits in csrc/decode_gqa.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = load_library(SOURCE)
    lib.dg_forward.argtypes = ([_P] * 6 + [_I] * 5 + [_L] * 8
                               + [ctypes.c_float, _I, _I, _P])
    lib.dg_key_tile.argtypes = [_I, _I]
    lib.dg_max_active_clusters.argtypes = []
    for fn in (lib.dg_forward, lib.dg_key_tile, lib.dg_max_active_clusters):
        fn.restype = ctypes.c_int
    return lib


def max_active_clusters() -> int:
    """How many clusters of llama3.2-1b's instance (bf16 cache, Dh 64, four
    query heads a pass) the current card holds at once; a call launches
    B * KVH * ceil(G / 4) clusters, and those past this number wait for a
    second wave."""
    n = _library().dg_max_active_clusters()
    raise_on_error(-min(n, 0), "dg_max_active_clusters")
    return n


def _check(q, k, v, lengths) -> None:
    for name, x in (("k", k), ("v", v), ("lengths", lengths)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k)):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{x.dtype}")
    if v.dtype != k.dtype:
        raise TypeError(f"v is {v.dtype}, k is {k.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.ndim != 3 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, H, Dh] and k, v [B, S, KVH, Dh]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, dh = q.shape
    if (k.shape[0] != b or k.shape[3] != dh or h % k.shape[2] != 0
            or lengths.shape != (b,)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and lengths "
                         f"{tuple(lengths.shape)} disagree")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def check_alignment(k, v) -> None:
    """Raise unless k and v have 16-byte-aligned base addresses, strides
    (a dimension of extent 1 is never stepped) and rows, as the kernel's
    16-byte vector loads need."""
    for name, x in (("k", k), ("v", v)):
        size = x.element_size()
        if (x.data_ptr() % 16 or x.shape[3] * size % 16
                or any(x.stride(d) * size % 16
                       for d in range(3) if x.shape[d] > 1)):
            raise ValueError(
                f"{name}: the decode kernel reads rows in 16-byte vectors and "
                f"needs 16-byte-aligned base addresses, strides and rows; got "
                f"address % 16 = {x.data_ptr() % 16}, shape "
                f"{tuple(x.shape)}, strides {tuple(x.stride())} of "
                f"{size}-byte elements")


def decode_gqa_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False):
    """One decode position of GQA attention over a [B, S, KVH, Dh] cache;
    with ``return_lse`` (out, lse)."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return decode_gqa_ref(q, k, v, lengths, return_lse)
    b, h, dh = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} exceeds the kernel's {MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim stride must be 1")
    check_alignment(k, v)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    lse = (torch.empty((b, h), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0 or s == 0:
        return (out.zero_(), lse.fill_(-math.inf)) if return_lse \
            else out.zero_()
    lib = _library()
    lengths = lengths.contiguous()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dg_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h,
            kvh, dh, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), k.stride(2), v.stride(0),
            v.stride(1), v.stride(2), 1.0 / math.sqrt(dh), _DTYPES[q.dtype],
            _DTYPES[k.dtype], stream)
    raise_on_error(err, "dg_forward")
    LAUNCHES["decode_gqa_lse" if return_lse else "decode_gqa"] += 1
    return (out, lse) if return_lse else out
