"""Serving example: batched requests through the continuous-batching engine
with a reduced hymba (hybrid attention + SSM) model, which drives the
rolling-window KV cache and the recurrent state's decode path.

    python -m repro_torch.examples.serve_lm [--smoke] [--device cpu]

The port's counterpart of the JAX package's ``examples/serve_lm.py``: the
same reduced hymba-1.5b, engine and requests, with weights drawn from a
``torch.Generator`` seeded 0 on ``--device`` (the card by default).
``--smoke`` serves 4 requests of 6 new tokens in place of 8 of 12.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import build_model, get_config, reduced_config
from ..serve.engine import Request, ServeEngine
from . import parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    n_reqs, max_new = (4, 6) if args.smoke else (8, 12)
    device = resolve_device(args.device)
    cfg = reduced_config(get_config("hymba-1.5b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = ServeEngine(model, params, max_batch=4, max_seq=64)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab, size=6).astype(np.int32),
                    max_new_tokens=max_new)
            for i in range(n_reqs)]
    for r in reqs:
        engine.submit(r)

    t0 = time.perf_counter()
    tokens = 0
    while engine.waiting or engine.n_active:
        tokens += engine.step()
    print(f"served {len(reqs)} requests / {tokens} tokens "
          f"in {time.perf_counter() - t0:.1f}s")
    for r in reqs[:4]:
        print(f"  req{r.rid}: {r.prompt.tolist()} -> {r.out_tokens}")
    if not all(r.done for r in reqs):
        raise RuntimeError("the engine stopped with requests unanswered")


if __name__ == "__main__":
    main()
