"""Launchers of the moment-curve CUDA kernels (``csrc/moment_curves.cu``).

Each kernel comes in two forms, by how a row's parameters arrive:

* belief form (the simulator's main path): the slot table's ``GammaBelief``
  columns, ``cores`` (float32 [D] each) and, for the aggregate, the bool
  ``alive`` column; the kernel computes ``pack_belief``'s factors itself.

  * ``moment_curves_belief``     -> (EL, VL), each [D, N]   (per-row curves)
  * ``moment_curves_agg_belief`` -> (EL, VL), each [N]      (sum over rows
    weighted by ``alive``: the cluster aggregate); given R runs' slot
    tables (columns [R, D]), each [R, N] from one launch, run r's with the
    bits of a launch on its rows alone. A grid of more than ``AGG_MAX_N``
    points goes in chunks of at most ``AGG_MAX_N``, one launch a chunk,
    each chunk's columns with the bits of a launch over any grid that
    holds them

* packed form (the TPU kernel's interface): packed rows ``params [D, 16]``
  (column layout in ``ref.py``).

  * ``moment_curves_packed``, ``moment_curves_agg_packed``: the same.

All take the horizon grid ``t [N]`` and the D-term's two-point interpolation
``idx [N]`` int32 / ``frac [N]`` f32 (``core.moments.interp_points``). On CPU
tensors they return the plain PyTorch versions of ``ref.py``; on CUDA tensors
they launch the kernel on the current stream, or raise. ``LAUNCHES`` counts
the kernel launches of each wrapper (the plain versions add nothing), so a
run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from ...core.belief import GammaBelief
from ...core.processes import F32, PopulationPriors
from .._build import load_library, raise_on_error
from .ref import (AGG_ROWS_PER_CTA, N_COLS, moment_curves_agg_belief_ref,
                  moment_curves_agg_packed_ref, moment_curves_belief_ref,
                  moment_curves_packed_ref, pack_constants)

SOURCE = Path(__file__).resolve().parent / "csrc" / "moment_curves.cu"

LAUNCHES = {"moment_curves_belief": 0, "moment_curves_agg_belief": 0,
            "moment_curves_packed": 0, "moment_curves_agg_packed": 0}

MAX_ND = 32        # D-term checkpoints: at most one a lane of a warp
AGG_MAX_N = 256    # grid points of the aggregate (its shared-memory sums)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (device index, stream handle) -> the aggregate's grid-barrier slot
_BARRIER_SLOTS: dict = {}
# guards the build and the slot table: launchers are called from several
# threads (the online engine's pump and deadline threads, its caller), and
# two streams handed one slot would share one grid barrier
_LOCK = threading.RLock()
# (device index, belief form, N) -> mc_agg_capacity's numbers
_AGG_RESIDENCY: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The built library with its C signatures declared (built on first
    use; two threads that miss the cache at once build it one after the
    other, and the second finds it loaded)."""
    with _LOCK:
        return _declare(load_library(SOURCE))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    cols = [_P] * 7
    consts = [_F] * 5
    grids = [_P, _P, _P, _I, _I, _I]                      # t, idx, frac, d, n, nd
    lib.mc_rows.argtypes = [_P, *grids, _P, _P, _P]
    lib.mc_rows_belief.argtypes = [*cols, *consts, *grids, _P, _P, _P]
    lib.mc_agg.argtypes = [_P, *grids, _I, _P, _P, _I, _P]
    # t, idx, frac, t_last, runs, d, n, nd, g, ctas
    lib.mc_agg_belief.argtypes = [*cols, _P, *consts, _P, _P, _P, _P,
                                  *[_I] * 6, _P, _P, _I, _P]
    lib.mc_agg_capacity.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 4
    lib.mc_empty.argtypes = [_P]
    for fn in (lib.mc_rows, lib.mc_rows_belief, lib.mc_agg, lib.mc_agg_belief,
               lib.mc_agg_capacity, lib.mc_empty, lib.mc_agg_rows_per_cta,
               lib.mc_agg_max_n, lib.mc_max_nd, lib.mc_barrier_slots):
        fn.restype = ctypes.c_int
    built = (lib.mc_max_nd(), lib.mc_agg_max_n(), lib.mc_agg_rows_per_cta())
    if built != (MAX_ND, AGG_MAX_N, AGG_ROWS_PER_CTA):
        raise RuntimeError(f"{SOURCE.name} was built with limits {built}, the "
                           f"launchers expect "
                           f"{(MAX_ND, AGG_MAX_N, AGG_ROWS_PER_CTA)}")
    return lib


def agg_residency(belief: bool, n: int, device=None) -> dict:
    """The aggregate kernel on ``device`` (the current one if None) at ``n``
    grid points: CTAs an SM, SMs, registers a thread, local (spill) bytes a
    thread, from cudaOccupancyMaxActiveBlocksPerMultiprocessor and
    cudaFuncGetAttributes."""
    dev = torch.device("cuda", torch.cuda.current_device()
                       if device is None else torch.device(device).index)
    key = (dev.index, bool(belief), n)
    if key not in _AGG_RESIDENCY:
        vals = [_I() for _ in range(4)]
        with torch.cuda.device(dev):
            err = _library().mc_agg_capacity(int(belief), n,
                                             *map(ctypes.byref, vals))
        raise_on_error(err, "mc_agg_capacity")
        _AGG_RESIDENCY[key] = dict(zip(
            ("ctas_per_sm", "sms", "registers", "local_bytes"),
            (v.value for v in vals)))
    return _AGG_RESIDENCY[key]


def _barrier_slot(device_index: int, stream: int) -> int:
    """The grid-barrier slot of ``stream`` on device ``device_index``: one
    slot a stream, handed out once under the lock."""
    key = (device_index, stream)
    with _LOCK:
        slot = _BARRIER_SLOTS.get(key)
        if slot is None:
            slot = sum(1 for d, _ in _BARRIER_SLOTS if d == device_index)
            if slot >= _library().mc_barrier_slots():
                raise RuntimeError("the aggregate kernel has a grid barrier "
                                   f"for {slot} streams a device; all are "
                                   "taken")
            _BARRIER_SLOTS[key] = slot
    return slot


def _check_grids(dev, t, idx, frac, nd: int) -> int:
    """Validate the grid inputs against device ``dev``; returns N."""
    n = t.shape[-1]
    for name, x, dtype in (("t", t, F32), ("idx", idx, torch.int32),
                           ("frac", frac, F32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the rows on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.shape != (n,) or not x.is_contiguous():
            raise ValueError(f"t, idx, frac must all be contiguous [N >= 1], "
                             f"got {name} {tuple(x.shape)}")
    if n < 1:
        raise ValueError("the horizon grid is empty")
    if not 1 <= nd <= MAX_ND:
        raise ValueError(f"nd={nd} must be in [1, {MAX_ND}]: the kernels "
                         "give each D-term checkpoint one lane of a warp")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n


def _check_belief(bel, cores, alive, t, idx, frac, nd: int) -> int:
    """Validate the belief form's inputs (columns [D], or R runs' [R, D]);
    returns N."""
    cols = (*bel, cores)
    dev, shape = cores.device, tuple(cores.shape)
    dims = "[D] or [R, D]"
    if len(shape) not in (1, 2):
        raise ValueError(f"belief columns and cores must be contiguous "
                         f"{dims}, got {shape}")
    for x in cols:
        if x.dtype != F32:
            raise TypeError(f"belief columns and cores must be float32, got "
                            f"{x.dtype}")
        if x.device != dev:
            raise ValueError(f"belief columns on {x.device} and {dev}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"belief columns and cores must be contiguous "
                             f"{dims}, got {tuple(x.shape)} against {shape}")
    if alive is not None:
        if alive.dtype != torch.bool:
            raise TypeError(f"alive must be torch.bool, got {alive.dtype}")
        if alive.device != dev:
            raise ValueError(f"alive is on {alive.device}, the rows on {dev}")
        if tuple(alive.shape) != shape or not alive.is_contiguous():
            raise ValueError(f"alive must be contiguous {list(shape)}, got "
                             f"{tuple(alive.shape)}")
    if 0 in shape:
        raise ValueError("no rows" if shape[-1] == 0 else "no runs")
    return _check_grids(dev, t, idx, frac, nd)


def _check_packed(params, t, idx, frac, nd: int) -> int:
    """Validate the packed form's inputs; returns N."""
    if params.dtype != F32:
        raise TypeError(f"params must be float32, got {params.dtype}")
    if (params.ndim != 2 or params.shape[1] != N_COLS or params.shape[0] < 1
            or not params.is_contiguous()):
        raise ValueError(f"params must be contiguous [D >= 1, {N_COLS}], got "
                         f"{tuple(params.shape)}")
    return _check_grids(params.device, t, idx, frac, nd)


def _check_agg_n(n: int) -> None:
    if n > AGG_MAX_N:
        raise ValueError(f"N={n} exceeds the aggregate kernel's {AGG_MAX_N} "
                         "grid points")


def agg_chunks(n: int) -> list:
    """The (start, stop) grid-point ranges of the aggregate's launches
    over ``n`` points: chunks of ``AGG_MAX_N``, the last one shorter."""
    return [(k, min(k + AGG_MAX_N, n)) for k in range(0, n, AGG_MAX_N)]


def _stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current stream: what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, without building a
    Stream object, which took more host time than the launch."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _call(dev: torch.device, fn, *args) -> None:
    """Call C entry point ``fn`` with ``dev`` as the current device,
    switching device only when it is not the current one."""
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    raise_on_error(err, fn.__name__)


def _agg_grid(dev, belief: bool, d: int, n: int) -> tuple[int, int]:
    """(CTAs of a one-run aggregate launch over ``d`` rows, CTAs the card
    holds at once): the grid takes every block of rows at once, or as many
    CTAs as the card holds."""
    res = agg_residency(belief, n, dev)
    resident = res["ctas_per_sm"] * res["sms"]
    return min(-(-d // AGG_ROWS_PER_CTA), resident), resident


def moment_curves_belief(bel: GammaBelief, cores: torch.Tensor,
                         t: torch.Tensor, idx: torch.Tensor,
                         frac: torch.Tensor, nd: int,
                         priors: PopulationPriors):
    """Per-row curves (EL, VL), each [D, N], from the belief columns."""
    n = _check_belief(bel, cores, None, t, idx, frac, nd)
    if cores.ndim != 1:
        raise ValueError(f"per-row curves take columns [D], got "
                         f"{tuple(cores.shape)}")
    dev = cores.device
    if dev.type == "cpu":
        return moment_curves_belief_ref(bel, cores, t, idx, frac, nd, priors)
    lib = _library()
    d = cores.shape[0]
    out = torch.empty((2, d, n), dtype=F32, device=dev)
    el = out.data_ptr()
    _call(dev, lib.mc_rows_belief, *(x.data_ptr() for x in bel),
          cores.data_ptr(), *pack_constants(priors), t.data_ptr(),
          idx.data_ptr(), frac.data_ptr(), d, n, nd, el, el + 4 * d * n,
          _stream(dev))
    LAUNCHES["moment_curves_belief"] += 1
    return out.unbind(0)


def moment_curves_agg_belief(bel: GammaBelief, cores: torch.Tensor,
                             alive: torch.Tensor, t: torch.Tensor,
                             idx: torch.Tensor, frac: torch.Tensor, nd: int,
                             priors: PopulationPriors):
    """Aggregate curves (EL, VL): sums over rows weighted by ``alive``,
    reduced in a fixed order (bitwise deterministic). Columns [D] give each
    [N]; R runs' columns [R, D] give each [R, N] from one launch, run r's
    with the bits of a launch on its rows alone. The scratch for the CTA
    partials ([R, 2N, g] floats, g the one-run grid) is allocated with the
    output at every call.

    N > ``AGG_MAX_N``: one launch a chunk of ``agg_chunks(N)``, each on its
    slice of ``t``/``idx``/``frac`` with the whole grid's checkpoint
    spacing (``t[-1] / nd``); the chunks' columns are joined after. The
    plain version on the CPU takes any N in one call."""
    n = _check_belief(bel, cores, alive, t, idx, frac, nd)
    dev = cores.device
    if dev.type == "cpu":
        return moment_curves_agg_belief_ref(bel, cores, alive, t, idx, frac,
                                            nd, priors)
    if n <= AGG_MAX_N:
        return _agg_belief_launch(bel, cores, alive, t, idx, frac, t, nd,
                                  priors)
    parts = [_agg_belief_launch(bel, cores, alive, t[a:b], idx[a:b],
                                frac[a:b], t, nd, priors)
             for a, b in agg_chunks(n)]
    return tuple(torch.cat(x, dim=-1) for x in zip(*parts))


def _agg_belief_launch(bel, cores, alive, t, idx, frac, t_grid, nd: int,
                       priors):
    """One aggregate launch over the checked inputs: ``t``/``idx``/``frac``
    hold at most ``AGG_MAX_N`` points of the grid ``t_grid``, whose last
    point sets the checkpoint spacing."""
    lib = _library()
    dev, n = cores.device, t.shape[0]
    runs, d = (1, *cores.shape) if cores.ndim == 1 else cores.shape
    grid, resident = _agg_grid(dev, True, d, n)
    size = 2 * n * runs
    out = torch.empty(size * (1 + grid), dtype=F32, device=dev)
    stream, ptr = _stream(dev), out.data_ptr()
    t_last = t_grid.data_ptr() + 4 * (t_grid.shape[0] - 1)
    _call(dev, lib.mc_agg_belief, *(x.data_ptr() for x in bel),
          cores.data_ptr(), alive.data_ptr(), *pack_constants(priors),
          t.data_ptr(), idx.data_ptr(), frac.data_ptr(), t_last, runs, d, n,
          nd, grid, min(runs * grid, resident), ptr + 4 * size, ptr,
          _barrier_slot(dev.index, stream), stream)
    LAUNCHES["moment_curves_agg_belief"] += 1
    curves = out[:size].view(*cores.shape[:-1], 2, n)
    return curves[..., 0, :], curves[..., 1, :]


def moment_curves_packed(params: torch.Tensor, t: torch.Tensor,
                         idx: torch.Tensor, frac: torch.Tensor, nd: int):
    """Per-row curves (EL, VL), each [D, N], from packed rows."""
    n = _check_packed(params, t, idx, frac, nd)
    dev = params.device
    if dev.type == "cpu":
        return moment_curves_packed_ref(params, t, idx, frac, nd)
    d = params.shape[0]
    out = torch.empty((2, d, n), dtype=F32, device=dev)
    el = out.data_ptr()
    _call(dev, _library().mc_rows, params.data_ptr(), t.data_ptr(),
          idx.data_ptr(), frac.data_ptr(), d, n, nd, el, el + 4 * d * n,
          _stream(dev))
    LAUNCHES["moment_curves_packed"] += 1
    return out.unbind(0)


def moment_curves_agg_packed(params: torch.Tensor, t: torch.Tensor,
                             idx: torch.Tensor, frac: torch.Tensor, nd: int):
    """Aggregate curves (EL, VL), each [N], from packed rows: sums over rows
    weighted by the ALIVE column, reduced in a fixed order (bitwise
    deterministic)."""
    n = _check_packed(params, t, idx, frac, nd)
    _check_agg_n(n)
    dev = params.device
    if dev.type == "cpu":
        return moment_curves_agg_packed_ref(params, t, idx, frac, nd)
    d = params.shape[0]
    grid, _ = _agg_grid(dev, False, d, n)
    out = torch.empty(2 * n * (1 + grid), dtype=F32, device=dev)
    stream, ptr = _stream(dev), out.data_ptr()
    _call(dev, _library().mc_agg, params.data_ptr(), t.data_ptr(),
          idx.data_ptr(), frac.data_ptr(), d, n, nd, grid, ptr + 8 * n, ptr,
          _barrier_slot(dev.index, stream), stream)
    LAUNCHES["moment_curves_agg_packed"] += 1
    return out[:n], out[n:2 * n]


def launch_empty() -> None:
    """One launch of an empty kernel on the current stream: the launch
    floor a kernel's time is read against."""
    dev = torch.device("cuda", torch.cuda.current_device())
    _call(dev, _library().mc_empty, _stream(dev))
