#!/usr/bin/env python3
"""Time the port's bf16 flash-attention kernel, or its GQA decode kernel, on
one CUDA card, for one or more checkouts of the port, in turns.

    python3 tools/torch_flash_bench.py [--kernel flash|decode] [--roots A B]
                                       [--order ABBA]

Each turn is one process that imports ``repro_torch`` from ``ROOT/src`` of
one checkout (building its kernel into that checkout's ``build/``), checks
the kernel against the plain version, and times it with ``chip_smoke.py``'s
``graph_ms`` (the median over 7 replays of a CUDA graph of 50 calls):

- flash: llama3.2-1b's prefill shape (B = 2, S = 2,048, H = 32 over KVH = 8,
  Dh = 64, causal) and the Dh = 128 shape (H = 16 over KVH = 4);
- decode: phase 7's shape (B = 4, 2,048 valid keys of a 4,096-slot bf16
  cache, H = 32 over KVH = 8, Dh = 64), warm (one cache) and cold (the graph
  takes ``COLD_CACHES`` caches in turn, more valid K/V than the L2 holds),
  warm at 0 and 4,096 valid keys (the cost of a call that reads nothing,
  and of twice the keys), and SDPA on the same inputs; then the same
  caches with G = 8 (H = 64 over KVH = 8, ``decode_g8``), warm and cold,
  beside SDPA.

Turns run in the order given (A B B A by default), so two versions are
compared on one card in one call. Prints one JSON object a turn and the
card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"dh64": (2, 2048, 32, 8, 64), "dh128": (2, 2048, 16, 4, 128)}
DECODE_SHAPE = dict(B=4, slots=4096, valid=2048, H=32, KVH=8, Dh=64)

sys.path.insert(0, str(ROOT))
from chip_smoke import COLD_CACHES, DECODE_TOL, graph_ms, sdpa  # noqa: E402


def flash_turn(gen, out):
    import torch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.flash_attention import ref as FR

    for name, (b, s, h, kvh, dh) in SHAPES.items():
        q, k, v = (torch.randn((b, s, n, dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for n in (h, kvh, kvh))
        kern = lambda: FA.flash_attention_bshd(q, k, v, causal=True)
        want = FR.flash_attention_ref(q, k, v, causal=True).float()
        torch.testing.assert_close(kern().float(), want, rtol=8e-3,
                                   atol=1e-5)
        out[name] = graph_ms(kern)


def decode_turn(gen, out):
    import torch
    from repro_torch.kernels.decode_gqa import kernel as DG
    from repro_torch.kernels.decode_gqa import ref as DR

    c = DECODE_SHAPE
    shape = (c["B"], c["slots"], c["KVH"], c["Dh"])
    rand = lambda shp: torch.randn(shp, generator=gen,
                                   device="cuda").to(torch.bfloat16)
    caches = [(rand(shape), rand(shape)) for _ in range(COLD_CACHES)]
    k, v = caches[0]
    lens = torch.full((c["B"],), c["valid"], dtype=torch.int32,
                      device="cuda")
    valid = c["valid"]
    for key, h in (("decode", c["H"]), ("decode_g8", 8 * c["KVH"])):
        q = rand((c["B"], h, c["Dh"]))
        call = lambda kc, vc: DG.decode_gqa_bshd(q, kc, vc, lens)
        torch.testing.assert_close(call(k, v),
                                   DR.decode_gqa_ref(q, k, v, lens),
                                   **DECODE_TOL)
        out[key] = graph_ms(lambda: call(k, v))
        out[key + "_cold"] = graph_ms([lambda kc=kc, vc=vc: call(kc, vc)
                                       for kc, vc in caches])
        if key == "decode":
            # what a call costs with no key to read, and with twice the keys
            for fill in (0, 2 * valid):
                lens.fill_(fill)
                out[f"{key}_len{fill}"] = graph_ms(lambda: call(k, v))
            lens.fill_(valid)
        lib = "sdpa" + key[len("decode"):]
        out[lib] = graph_ms(lambda: sdpa(q[:, None], k[:, :valid],
                                         v[:, :valid], False))
        out[lib + "_cold"] = graph_ms([
            lambda kc=kc, vc=vc: sdpa(q[:, None], kc[:, :valid],
                                      vc[:, :valid], False)
            for kc, vc in caches])


def turn(root, kernel):
    """One checkout's times, in this process."""
    import torch

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    out = {"root": str(root), "kernel": kernel}
    gen = torch.Generator(device="cuda").manual_seed(9)
    if kernel == "flash":
        flash_turn(gen, out)
    else:
        decode_turn(gen, out)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("flash", "decode"), default="flash")
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
        print(json.dumps(turn(args.turn, args.kernel)), flush=True)
        return
    order = args.order or ("A" if len(args.roots) == 1 else "ABBA")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    for letter in order:
        root = args.roots[ord(letter) - ord("A")]
        subprocess.run([sys.executable, __file__, "--turn", root,
                        "--kernel", args.kernel], check=True)


if __name__ == "__main__":
    main()
