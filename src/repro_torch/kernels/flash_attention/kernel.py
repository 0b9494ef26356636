"""Launcher of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention_bshd(q, k, v, causal=, window=)`` takes q [B, Sq, H, Dh]
and k/v [B, Sk, KVH, Dh] in one dtype (float32 or bfloat16) and returns
[B, Sq, H, Dh] in that dtype. On CPU tensors it returns the plain PyTorch
version of ``ref.py``; on CUDA tensors it launches the kernel on the current
stream, or raises. The kernel reads its inputs through their strides (the
head_dim stride must be 1), so nothing is transposed or padded. The bf16
kernel copies its tiles with TMA, which needs 16-byte-aligned base addresses
and strides: the launcher refuses a bf16 view without them rather than copy
it. ``LAUNCHES`` counts the kernel launches (the plain version adds
nothing).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .._build import load_library, raise_on_error
from .ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = load_library(SOURCE)
    lib.fa_forward.argtypes = ([_P] * 4 + [_I] * 6 + [_L] * 9
                               + [_I, _I, ctypes.c_float, _I, _P])
    lib.fa_forward.restype = ctypes.c_int
    return lib


def _check(q, k, v) -> None:
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B, Sq, H, Dh] and k, v [B, Sk, KVH, Dh]"
                         f"; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head_dim, or H is not a multiple of KVH")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def check_tma_alignment(q, k, v) -> None:
    """Raise unless q, k and v have 16-byte-aligned base addresses and
    strides (a dimension of extent 1 is never stepped), as the bf16
    kernel's TMA copies need."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        size = x.element_size()
        if x.data_ptr() % 16 or any(x.stride(d) * size % 16
                                    for d in range(3) if x.shape[d] > 1):
            raise ValueError(
                f"{name}: the bf16 flash kernel needs 16-byte-aligned base "
                f"addresses and strides (TMA); got address % 16 = "
                f"{x.data_ptr() % 16}, strides {tuple(x.stride())} of "
                f"{size}-byte elements")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA attention, [B, S, H, Dh] layout."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim stride must be 1")
    if q.dtype == torch.bfloat16:
        check_tma_alignment(q, k, v)
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, h, kvh, dh, q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2), v.stride(0), v.stride(1),
            v.stride(2), int(causal), int(window), 1.0 / math.sqrt(dh),
            _DTYPES[q.dtype], stream)
    raise_on_error(err, "fa_forward")
    LAUNCHES["flash_attention"] += 1
    return out
