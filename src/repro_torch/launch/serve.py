"""Serving launcher: batched requests through the continuous-batching engine.

Usage (on a card; ``--device cpu`` runs the plain lanes on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --requests 12 --max-new 16

``--arch`` takes any of the registry's ten architectures
(``models.ARCH_NAMES``); ``--reduced`` serves its tiny same-family config.

The weights are drawn from ``--seed`` by the port's own ``init`` (no
checkpoint is read), as the JAX package's launcher does, and the engine
decodes over ``launch.mesh.make_host_mesh`` of ``--device``: one device
unless ``REPRO_TORCH_DEVICE_COUNT=N`` asks for N logical ones, over which
the cache's sequence is sharded.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import ARCH_NAMES, build_model, get_config, reduced_config
from ..serve.engine import Request, ServeEngine
from .mesh import make_host_mesh


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """(cfg, model, params): the architecture with weights from the seed."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, model, model.init(gen, device=device)


def make_requests(args: argparse.Namespace, vocab: int) -> list:
    """The launcher's requests: prompts of 4-11 tokens drawn from the seed."""
    rng = np.random.default_rng(args.seed)
    return [
        Request(rid=i,
                prompt=rng.integers(2, vocab, size=rng.integers(4, 12))
                .astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]


def serve(model, params, args: argparse.Namespace, vocab: int,
          prefill_mode: str = "fused"):
    """Answer the launcher's requests; returns (requests, completed,
    seconds)."""
    engine = ServeEngine(model, params, max_batch=args.max_batch,
                         max_seq=args.max_seq, prefill_mode=prefill_mode,
                         mesh=make_host_mesh(params["embed"].device))
    reqs = make_requests(args, vocab)
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    return reqs, done, time.perf_counter() - t0


def main(argv=None):
    args = parse_args(argv)
    cfg, model, params = build(args)
    reqs, done, dt = serve(model, params, args, cfg.vocab)
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)}/{len(reqs)} requests, {tokens} tokens in "
          f"{dt:.1f}s ({tokens / max(dt, 1e-9):.1f} tok/s)")
    for r in reqs[:3]:
        print(f"  req{r.rid}: prompt={r.prompt.tolist()} -> "
              f"{r.out_tokens[:8]}...")


if __name__ == "__main__":
    main()
