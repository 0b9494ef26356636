#!/usr/bin/env python3
"""Where the moment-curve aggregate kernel's time goes, phase by phase.

Builds a copy of ``src/repro_torch/kernels/moment_curves/csrc/moment_curves.cu``
with timers (``clock64`` in thread 0 of each CTA at the ends of its phases,
``%globaltimer`` at its start, barrier arrival and end) into ``build/``, runs
the aggregate at the simulator's shape (D = 8,192, N = 48, ND = 24) in both
forms on one CUDA card, and prints the median cycles of each phase over the
CTAs, how far apart the CTAs reach the grid barrier, and the SM clock. The
timers add a few instructions a phase; read the kernel's own time from
``chip_smoke.py`` phase 3.

    python3 tools/torch_mc_phases.py [--reps 3]
"""
import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (anchor in the source, code put just before or after it)
TIMERS = [
    ("__device__ unsigned int g_barrier[kBarrierSlots];", "after",
     "\n__device__ unsigned long long g_stamp[1024][16];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "#define CLOCK(i) if (threadIdx.x == 0) g_stamp[blockIdx.x][i] = "
     "clock64();\n"
     "#define GTIME(i) if (threadIdx.x == 0) g_stamp[blockIdx.x][i] = "
     "gtime();\n"),
    ("  float* acc = acc_s + (size_t)warp * 2 * n;", "before",
     "  GTIME(8)\n  CLOCK(0)\n"),
    ("    const Row r = row_from(rows_s[my]);\n", "after", "    CLOCK(1)\n"),
    ("    d_term<kAggLanes>(r, w, nd, j, f_s[my], ed_s[warp][half]);\n",
     "after", "    CLOCK(2)\n"),
    ("    raw = next_raw;\n  }\n", "after", "  CLOCK(3)\n"),
    ("  grid_barrier(&g_barrier[slot], ctas);\n", "before",
     "  CLOCK(4)\n  GTIME(9)\n"),
    ("  grid_barrier(&g_barrier[slot], ctas);\n", "after",
     "  CLOCK(5)\n  GTIME(10)\n"),
    ("    if (lane == 0) out[o] = s;\n  }\n}", "after-final",
     "  __syncthreads();\n  CLOCK(6)\n  GTIME(11)\n"),
    ("int mc_empty(void* stream) {", "before",
     "int mc_stamps(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_stamp, sizeof(g_stamp));\n"
     "}\n\n"),
]
PHASES = ["stage, pack and survival terms", "rest of the D-term",
          "grid points", "CTA sum", "grid barrier", "sum across CTAs"]


def instrumented(src: str) -> str:
    for anchor, where, code in TIMERS:
        if anchor not in src:
            raise SystemExit(f"anchor not found in the kernel source: "
                             f"{anchor!r}; update tools/torch_mc_phases.py")
        if where == "before":
            src = src.replace(anchor, code + anchor, 1)
        elif where == "after":
            src = src.replace(anchor, anchor + code, 1)
        else:   # before the closing brace of the kernel
            src = src.replace(anchor, anchor[:-1] + code + "}", 1)
    return src


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_mc_phases: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.kernels.moment_curves import kernel as K

    path = ROOT / "build" / "torch_mc_phases" / "moment_curves.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(instrumented(K.SOURCE.read_text()))
    K.SOURCE = path
    K._library.cache_clear()
    lib = K._library()
    lib.mc_stamps.argtypes = [ctypes.c_void_p]
    print(C.card_line())
    calls = C.kernel_calls(8192, 48, 24, 11, "cuda")
    for name in ("moment_curves_agg_belief", "moment_curves_agg_packed"):
        kern, _, call_args = calls[name]
        for _ in range(20):
            kern(*call_args)
        for rep in range(args.reps):
            torch.cuda.synchronize()
            kern(*call_args)
            torch.cuda.synchronize()
            stamps = np.zeros((1024, 16), dtype=np.uint64)
            if lib.mc_stamps(stamps.ctypes.data):
                raise RuntimeError("cudaMemcpyFromSymbol failed")
            grid = int(np.count_nonzero(stamps[:, 8]))
            s = stamps[:grid].astype(np.int64)
            cycles = {PHASES[i]: float(np.median(s[:, i + 1] - s[:, i]))
                      for i in range(6)}
            t0 = s[:, 8].min()
            arrive = s[:, 9] - t0
            print(f"{name} ({grid} CTAs), call {rep}: median cycles " +
                  ", ".join(f"{k} {v:.0f}" for k, v in cycles.items()) +
                  f"; ns after the first CTA starts: CTAs start within "
                  f"{s[:, 8].max() - t0}, reach the barrier "
                  f"{arrive.min()}-{arrive.max()}, leave it "
                  f"{(s[:, 10] - t0).min()}-{(s[:, 10] - t0).max()}, "
                  f"end by {(s[:, 11] - t0).max()}; SM clock "
                  f"{(s[0, 5] - s[0, 0]) / (s[0, 10] - s[0, 8]):.3f} GHz",
                  flush=True)


if __name__ == "__main__":
    main()
