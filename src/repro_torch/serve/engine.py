"""Batched serving engine: continuous-batching decode loop over a KV cache.

Requests enter a waiting queue; each engine step either (a) prefills a
waiting request into a free cache slot or (b) decodes one token for every
active slot. Slots whose sequence emits EOS (or hits max_new_tokens) free
their cache row. The JAX package's engine, on the port's ``DecoderLM``: the
engine runs where its parameters are, with a float32 cache as in the
reference, and its decode steps go through ``DecoderLM.decode_step`` (the
einsum attention path, as in the reference: the decode kernel's lane is
``layers.attention_decode(..., use_kernel=True)``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """``prefill_mode``: ``"loop"`` decodes the prompt token by token from
    host-built token vectors; ``"fused"`` is the reference's one-dispatch
    ``lax.scan`` prefill written as a loop over the prompt with the tokens
    kept on the device. Both run the same decode steps, so both give the
    same tokens."""

    def __init__(self, model, params, *, max_batch: int = 8,
                 max_seq: int = 512, eos_id: int = 1, mesh=None,
                 prefill_mode: str = "fused"):
        if prefill_mode not in ("fused", "loop"):
            raise ValueError(f"prefill_mode must be fused|loop: {prefill_mode}")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet: ROADMAP.md, Queue A, item 5 "
                "(telemetry, mesh and fleet)")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.prefill_mode = prefill_mode
        self.device = params["embed"].device
        self.cache = model.init_cache(max_batch, max_seq, dtype=torch.float32,
                                      device=self.device)
        self.active: list[Optional[Request]] = [None] * max_batch
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        self.tokens = np.zeros(max_batch, np.int32)

    def _decode(self, tokens: torch.Tensor):
        logits, self.cache = self.model.decode_step(self.params, tokens,
                                                    self.cache)
        return logits

    def _host_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(tokens.astype(np.int64)).to(self.device)

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """Next token of every slot: the first argmax, as ``jnp.argmax``."""
        return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)

    # -- queue management -----------------------------------------------------

    def submit(self, req: Request):
        self.waiting.append(req)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def _admit_one(self) -> bool:
        """Prefill one waiting request into a free slot (single-slot prefill:
        decode its prompt token by token into the shared cache row)."""
        if not self.waiting:
            return False
        try:
            slot = self.active.index(None)
        except ValueError:
            return False
        req = self.waiting.pop(0)
        # teacher-force the prompt through decode steps for this slot only
        # (other slots re-decode their current token, exactly as in the
        # token-by-token loop, so both modes advance the cache identically)
        if len(req.prompt) > 1:
            if self.prefill_mode == "fused":
                toks = self._host_tokens(self.tokens)
                prompt = self._host_tokens(np.asarray(req.prompt[:-1]))
                for i in range(prompt.shape[0]):
                    step_tokens = toks.clone()
                    step_tokens[slot] = prompt[i]
                    self._decode(step_tokens)
            else:
                for tok in req.prompt[:-1]:
                    step_tokens = self.tokens.copy()
                    step_tokens[slot] = tok
                    self._decode(self._host_tokens(step_tokens))
        self.tokens[slot] = int(req.prompt[-1])
        self.active[slot] = req
        return True

    def step(self) -> int:
        """One engine step; returns number of tokens emitted."""
        self._admit_one()
        if self.n_active == 0:
            return 0
        nxt = self._greedy(self._decode(self._host_tokens(self.tokens)))
        emitted = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.tokens[slot] = tok
            emitted += 1
            if tok == self.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.active[slot] = None
                self.finished.append(req)
        return emitted

    def run_until_drained(self, max_steps: int = 10_000) -> list:
        """Step until queues empty; returns the requests completed during
        this call (in completion order)."""
        n0 = len(self.finished)
        for _ in range(max_steps):
            if not self.waiting and self.n_active == 0:
                break
            self.step()
        return self.finished[n0:]
