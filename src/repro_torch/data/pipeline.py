"""Synthetic token pipeline with background prefetch, the JAX package's
``data/pipeline.py``.

``make_batch`` is the reference's numpy code, so a step's batch equals the
JAX package's bit for bit (the data position is a pure function of the
step: a restored checkpoint replays exactly). ``Prefetcher`` builds the
batches on a background thread and copies them to ``device`` (from pinned
host memory, without blocking, on a card), where the reference
``device_put``s them against the batch's shardings.

A real deployment would swap ``_synth_document`` for a tokenized corpus
reader; everything else stays.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device


class PipelineConfig:
    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frames_dim: int = 0, enc_seq: int = 0,
                 prefetch: int = 2):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.frames_dim = frames_dim
        self.enc_seq = enc_seq
        self.prefetch = prefetch


def _synth_document(rng: np.random.Generator, vocab: int, seq: int) -> np.ndarray:
    """Markovian synthetic tokens (learnable structure, not uniform noise):
    token_{t+1} = (a * token_t + noise) mod vocab with regime switches."""
    a = int(rng.integers(3, 17))
    x = np.empty(seq + 1, np.int64)
    x[0] = rng.integers(vocab)
    noise = rng.integers(0, 7, size=seq)
    for t in range(seq):
        x[t + 1] = (a * x[t] + noise[t]) % vocab
    return x


def make_batch(cfg: PipelineConfig, step: int) -> dict:
    """Deterministic batch for a global step (restart-safe: data position is
    a pure function of step, so checkpoint restore replays exactly)."""
    rng = np.random.default_rng((cfg.seed, step))
    toks = np.stack([
        _synth_document(rng, cfg.vocab, cfg.seq_len)
        for _ in range(cfg.global_batch)
    ])
    batch = {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
    if cfg.frames_dim:
        batch["frames"] = rng.standard_normal(
            (cfg.global_batch, cfg.enc_seq, cfg.frames_dim), np.float32)
    return batch


def to_device(batch: dict, device) -> dict:
    """A ``make_batch`` dict as tensors on ``device``: on a card, copied
    from pinned host memory without blocking the caller."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


class Prefetcher:
    """Batches from ``start_step`` on, built ``cfg.prefetch`` ahead on a
    background thread and placed on ``device`` (the card unless the caller
    passes ``"cpu"``). ``close()`` stops and joins the thread."""

    def __init__(self, cfg: PipelineConfig, device="cuda",
                 start_step: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            while not self._stop.is_set():
                batch = to_device(make_batch(self.cfg, self._step),
                                  self.device)
                self._step += 1
                self._put(batch)
        except Exception as e:  # handed to the consumer, raised by next()
            self._put(e)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                pass

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
