"""Training driver: end-to-end loop with checkpointing, fault tolerance and
a straggler watchdog, the JAX package's ``launch/train.py``.

Runs real steps on ``--device`` (the card unless ``--device cpu``) over
``launch.mesh.make_host_mesh``, as the reference does: one device unless
``REPRO_TORCH_DEVICE_COUNT=N`` asks for N logical ones, over whose
``model`` axis the state is then laid out (``train.step.state_shardings``).
The weights are drawn from ``--seed`` by the port's own ``init``, on the
device (nothing is downloaded); a restart restores ``LATEST`` into a
freshly built state, laid out over the mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 50 --ckpt-dir CKPT_DIR [--resume] [--fail-at 20]
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpoint import checkpointer
from ..data.pipeline import PipelineConfig, Prefetcher
from ..device import resolve_device
from ..models import ARCH_NAMES, build_model, get_config, reduced_config
from ..optim.adamw import AdamWConfig
from ..runtime.elastic import reshard_in_memory
from ..runtime.fault_tolerance import (FailureInjector, StragglerWatchdog,
                                       run_with_restarts)
from ..train.step import init_train_state, make_train_step, state_shardings
from .mesh import make_host_mesh


def build(args):
    """(cfg, model, mesh, step_fn, pipe_cfg) of the launcher's arguments."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg)
    mesh = make_host_mesh(args.device)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, mesh,
                              microbatches=args.microbatches,
                              compress=args.compress)
    pipe_cfg = PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.batch,
        frames_dim=cfg.d_model if cfg.family == "audio" else 0,
        enc_seq=cfg.enc_seq if cfg.family == "audio" else 0)
    return cfg, model, mesh, step_fn, pipe_cfg


def train(args) -> int:
    cfg, model, mesh, step_fn, pipe_cfg = build(args)
    device = resolve_device(args.device)
    sharded = mesh.size > 1
    ckpt = checkpointer.AsyncCheckpointer(args.ckpt_dir)
    injector = FailureInjector(tuple(args.fail_at))
    watchdog = StragglerWatchdog()

    def fresh_state(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        state = init_train_state(model, gen, compress=args.compress,
                                 device=device)
        if sharded:
            state = reshard_in_memory(state, model, mesh,
                                      compress=args.compress)
        return state

    def loop(_start_hint: int) -> int:
        start = 0
        state = None
        if args.resume or _start_hint != 0:
            # a save still being written when the step failed lands first,
            # so a restart resumes from the newest checkpoint, not a race
            ckpt.wait()
            latest = checkpointer.latest_step(args.ckpt_dir)
            if latest is not None:
                shardings = (state_shardings(model, mesh,
                                             compress=args.compress)
                             if sharded else None)
                state = checkpointer.restore(args.ckpt_dir, latest,
                                             fresh_state(0), shardings,
                                             device=device)
                start = latest
                print(f"[train] resumed from step {latest}")
        if state is None:
            state = fresh_state(args.seed)
        pipe = Prefetcher(pipe_cfg, device=device, start_step=start)
        try:
            for step in range(start, args.steps):
                batch = next(pipe)
                t0 = time.time()
                injector.maybe_fail(step)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
                dt = time.time() - t0
                straggler = watchdog.observe(step, dt)
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"{dt*1e3:.0f}ms"
                          + (" STRAGGLER" if straggler else ""))
                if (step + 1) % args.ckpt_every == 0:
                    ckpt.save_async(step + 1, state)
            ckpt.wait()
            checkpointer.save(args.ckpt_dir, args.steps, state)
            return args.steps
        finally:
            pipe.close()

    final = run_with_restarts(
        loop, max_restarts=3,
        on_restart=lambda i, e: print(f"[train] restart #{i + 1}: {e}"))
    print(f"[train] done at step {final}; straggler events: "
          f"{len(watchdog.events)}")
    return final


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps (FT test)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
