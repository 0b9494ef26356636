#!/usr/bin/env python3
"""Time the port's bf16 flash-attention kernel on one CUDA card, for one or
more checkouts of the port, in turns.

    python3 tools/torch_flash_bench.py [--roots A B] [--order ABBA]

Each turn is one process that imports ``repro_torch`` from ``ROOT/src`` of
one checkout (building its kernel into that checkout's ``build/``), checks
the kernel against the plain version at llama3.2-1b's prefill shape, and
times it there (B = 2, S = 2,048, H = 32 over KVH = 8, Dh = 64, causal) and
at the Dh = 128 shape (H = 16 over KVH = 4): the median over 7 replays of a
CUDA graph of 50 calls. Turns run in the order given (A B B A by default),
so two versions are compared on one card in one call. Prints one JSON
object a turn and the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"dh64": (2, 2048, 32, 8, 64), "dh128": (2, 2048, 16, 4, 128)}


def graph_ms(fn, reps=50, replays=7):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def turn(root):
    """One checkout's times, in this process."""
    import torch

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention import ref as FR

    out = {"root": str(root)}
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, (b, s, h, kvh, dh) in SHAPES.items():
        q, k, v = (torch.randn((b, s, n, dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        kern = lambda: FA.flash_attention_bshd(q, k, v, causal=True)
        want = FR.flash_attention_ref(q, k, v, causal=True).float()
        torch.testing.assert_close(kern().float(), want, rtol=8e-3,
                                   atol=1e-5)
        out[name] = graph_ms(kern)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", default=[str(ROOT)],
                    help="checkouts, named A, B, ... in --order")
    ap.add_argument("--order", default=None,
                    help="turns by letter; default ABBA (A with one root)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bench: needs a CUDA card")
    if args.turn:
        print(json.dumps(turn(args.turn)), flush=True)
        return
    order = args.order or ("A" if len(args.roots) == 1 else "ABBA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for letter in order:
        root = args.roots[ord(letter) - ord("A")]
        subprocess.run([sys.executable, __file__, "--turn", root],
                       check=True)


if __name__ == "__main__":
    main()
