#!/usr/bin/env python3
"""Run one cell of the benchmark of the admission system's PyTorch port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints progress and, last, each number the
check compared beside its limit on standard error, and one JSON result line
last on standard output. Exits with a code other than 0, and prints no
result, without as many CUDA cards as the cell asks for, without the port
(``src/repro_torch``), or when JAX or its package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program inside the checkout, at
    # fixed paths (the CUDA kernels build into build/repro_torch/ there)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    # one process, few threads: the step is the host's dispatch, and idle
    # intra-op workers only compete with it for the host's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    torch.set_num_threads(1)

    from perfbench import harness

    spec = harness.load_spec(args.workload)
    chips = int(spec.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), device="cuda", t0=T0)
    harness.refuse_forbidden()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
