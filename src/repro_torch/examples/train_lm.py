"""End-to-end training example: train a reduced llama3.2 config with
checkpointing and an injected failure + automatic restart (the
fault-tolerance path).

    python -m repro_torch.examples.train_lm [--smoke] [--device cpu]

The port's counterpart of the JAX package's ``examples/train_lm.py``: the
same reduced model, batch (8 x 128, 2 microbatches), learning rate and
failure half-way, through ``launch.train``, on ``--device`` (the card by
default), with checkpoints in a fresh temporary directory. It trains 200
steps with a checkpoint every 50; ``--smoke`` 8 steps with one every 2.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from ..launch.train import train
from . import parse_args


def main(argv=None):
    args = parse_args(__doc__, argv)
    steps, ckpt_every = (8, 2) if args.smoke else (200, 50)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_example_ckpt_")
    ns = argparse.Namespace(
        arch="llama3.2-1b", reduced=True, steps=steps, batch=8,
        seq_len=128, microbatches=2, lr=1e-3, ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every, log_every=max(steps // 8, 1), resume=False,
        compress=False,
        fail_at=[steps // 2],  # inject one failure mid-run
        seed=0, device=args.device)
    try:
        final = train(ns)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if final != steps:
        raise RuntimeError(f"stopped at step {final} of {steps}")
    print(f"trained to step {final} (through 1 injected failure + restart)")


if __name__ == "__main__":
    main()
