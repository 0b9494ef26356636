"""Launchers of the two moment-curve CUDA kernels (``csrc/moment_curves.cu``).

Both take packed rows ``params [D, 16]`` (column layout in ``ref.py``), the
horizon grid ``t [N]`` and the D-term's two-point interpolation ``idx [N]``
int32 / ``frac [N]`` f32 (``core.moments.interp_points``):

* ``moment_curves_packed``     -> (EL, VL), each [D, N]   (per-row curves)
* ``moment_curves_agg_packed`` -> (EL, VL), each [N]      (sum over rows
  weighted by the ALIVE column: the cluster aggregate)

On CPU tensors they return the plain PyTorch versions of ``ref.py``; on CUDA
tensors they launch the kernel on the current stream, or raise. ``LAUNCHES``
counts the kernel launches of each wrapper (the plain versions add nothing),
so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import load_library
from .ref import (N_COLS, moment_curves_agg_packed_ref,
                  moment_curves_packed_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "moment_curves.cu"

LAUNCHES = {"moment_curves_packed": 0, "moment_curves_agg_packed": 0}

MAX_ND = 32        # D-term checkpoints: one per lane of a warp
AGG_MAX_N = 256    # grid points of the aggregate: 8 accumulators per lane

_P, _I = ctypes.c_void_p, ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first use)."""
    lib = load_library(SOURCE)
    lib.mc_rows.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
    lib.mc_agg.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
    for fn in (lib.mc_rows, lib.mc_agg, lib.mc_agg_rows_per_cta,
               lib.mc_agg_max_n, lib.mc_max_nd):
        fn.restype = ctypes.c_int
    if (lib.mc_max_nd(), lib.mc_agg_max_n()) != (MAX_ND, AGG_MAX_N):
        raise RuntimeError(f"{SOURCE.name} was built with limits "
                           f"({lib.mc_max_nd()}, {lib.mc_agg_max_n()}), the "
                           f"launchers expect ({MAX_ND}, {AGG_MAX_N})")
    return lib


def _check(params, t, idx, frac, nd: int) -> str:
    """Validate the inputs; returns the device type they share."""
    dev = params.device
    for name, x, dtype in (("params", params, torch.float32),
                           ("t", t, torch.float32),
                           ("idx", idx, torch.int32),
                           ("frac", frac, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, params on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if params.ndim != 2 or params.shape[1] != N_COLS or params.shape[0] < 1:
        raise ValueError(f"params must be [D >= 1, {N_COLS}], got "
                         f"{tuple(params.shape)}")
    n = t.shape[-1]
    if t.ndim != 1 or idx.shape != (n,) or frac.shape != (n,) or n < 1:
        raise ValueError(f"t, idx, frac must all be [N >= 1], got "
                         f"{tuple(t.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(frac.shape)}")
    if not 1 <= nd <= MAX_ND:
        raise ValueError(f"nd={nd} must be in [1, {MAX_ND}]: the kernels "
                         "give each D-term checkpoint one lane of a warp")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_contiguous(params, t, idx, frac):
    for name, x in (("params", params), ("t", t), ("idx", idx),
                    ("frac", frac)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def moment_curves_packed(params: torch.Tensor, t: torch.Tensor,
                         idx: torch.Tensor, frac: torch.Tensor, nd: int):
    """Per-row curves (EL, VL), each [D, N]."""
    if _check(params, t, idx, frac, nd) == "cpu":
        return moment_curves_packed_ref(params, t, idx, frac, nd)
    _check_contiguous(params, t, idx, frac)
    lib = _library()
    d, n = params.shape[0], t.shape[0]
    el = torch.empty((d, n), dtype=torch.float32, device=params.device)
    vl = torch.empty_like(el)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        err = lib.mc_rows(params.data_ptr(), t.data_ptr(), idx.data_ptr(),
                          frac.data_ptr(), d, n, nd, el.data_ptr(),
                          vl.data_ptr(), stream)
    _raise_on(err, "mc_rows")
    LAUNCHES["moment_curves_packed"] += 1
    return el, vl


def moment_curves_agg_packed(params: torch.Tensor, t: torch.Tensor,
                             idx: torch.Tensor, frac: torch.Tensor, nd: int):
    """Aggregate curves (EL, VL), each [N]: sums over rows weighted by the
    ALIVE column, reduced in a fixed order (bitwise deterministic)."""
    d, n = params.shape[0], t.shape[-1]
    if n > AGG_MAX_N:
        raise ValueError(f"N={n} exceeds the aggregate kernel's {AGG_MAX_N} "
                         "grid points")
    if _check(params, t, idx, frac, nd) == "cpu":
        return moment_curves_agg_packed_ref(params, t, idx, frac, nd)
    _check_contiguous(params, t, idx, frac)
    lib = _library()
    n_blocks = -(-d // lib.mc_agg_rows_per_cta())
    partial = torch.empty((2, n_blocks, n), dtype=torch.float32,
                          device=params.device)
    el = torch.empty((n,), dtype=torch.float32, device=params.device)
    vl = torch.empty_like(el)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        err = lib.mc_agg(params.data_ptr(), t.data_ptr(), idx.data_ptr(),
                         frac.data_ptr(), d, n, nd, partial.data_ptr(),
                         el.data_ptr(), vl.data_ptr(), stream)
    _raise_on(err, "mc_agg")
    LAUNCHES["moment_curves_agg_packed"] += 1
    return el, vl
