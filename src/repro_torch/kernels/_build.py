"""Build and load the port's CUDA kernels.

Each CUDA source under ``kernels/*/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library that the
launchers load with ``ctypes``. The build runs at the first CUDA call, into
``build/repro_torch/`` at the root of the checkout. The library's file name
carries a hash of its source, so an edited source is rebuilt and a stale
library is never loaded. A failed build raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# source path -> (loaded library, nvcc output, build seconds)
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in the CUDA toolkit's "
                       "default location; the CUDA kernels cannot be built")


def load_library(source: Path) -> ctypes.CDLL:
    """The compiled library of ``source``, building it on first use."""
    source = Path(source)
    if source in _LOADED:
        return _LOADED[source][0]
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    log, seconds = "", 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent build of the
        # same source never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[source] = (lib, log, seconds)
    return lib


def build_report(source: Path) -> tuple[str, float]:
    """(nvcc output, build seconds) of ``source``'s library in this process;
    empty and 0.0 when the library was already on disk."""
    _, log, seconds = _LOADED[Path(source)]
    return log, seconds
