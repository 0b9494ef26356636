"""Decoder-only LM: the dense and vlm families of the JAX package's
``models/lm.py``.

Block structure:  x += attn(ln1 x);  x += mlp(ln2 x).

``DecoderLM`` is stateless, as in the JAX package: ``init`` returns the
parameters (a ``Params`` module tree) and every method takes them first.
The JAX package's stacked ``layers`` axis is one ``Params`` submodule per
layer here, and its ``lax.scan`` over layers a Python loop. The moe, hybrid
and ssm families are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..device import resolve_device
from .layers import (AttnConfig, KVCache, _qkv, _sdpa, _sdpa_chunked,
                     attention, attention_decode, attention_params,
                     init_kv_cache, mlp, mlp_params, rmsnorm, rmsnorm_params)
from .spec import P, count_params, init_params

_NOT_PORTED = ("the {!r} family is not ported yet: ROADMAP.md, Queue A, "
               "item 10 (LM scaffold)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    window: int = 0             # sliding-window attention
    gated_mlp: bool = True
    n_experts: int = 0
    moe_top_k: int = 0
    moe_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    ssm_state: int = 0
    enc_layers: int = 0
    enc_seq: int = 1500
    scan_layers: bool = True
    remat: bool = True          # training only; inference ignores it
    attn_chunk: int = 0         # chunked attention block (0 = off)
    moe_local_dispatch: bool = False
    dtype: Any = torch.bfloat16  # activation/compute dtype
    use_flash_kernel: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self, causal=True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qk_norm=self.qk_norm, causal=causal, window=self.window,
            rope_theta=self.rope_theta, chunk=self.attn_chunk,
        )


class DecoderLM:
    """Decoder LM over a ``Params`` tree; every method is a plain function
    of its arguments. ``cfg.remat`` (activation checkpointing for training)
    has no meaning in inference and is ignored."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError(_NOT_PORTED.format(cfg.family))
        self.cfg = cfg

    # -- parameters ---------------------------------------------------------

    def _block_descriptors(self) -> dict:
        cfg = self.cfg
        d: dict = {"ln1": rmsnorm_params(cfg.d_model),
                   "attn": attention_params(cfg.attn_config())}
        if cfg.d_ff > 0:
            d["ln2"] = rmsnorm_params(cfg.d_model)
            d["ffn"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        return d

    def param_descriptors(self) -> dict:
        cfg = self.cfg
        tree: dict = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "final_norm": rmsnorm_params(cfg.d_model),
            "layers": [self._block_descriptors()
                       for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return tree

    def init(self, gen: torch.Generator, dtype=torch.float32, device="cuda"):
        """Parameters drawn from ``gen`` (on its own device), placed on
        ``device`` (the card unless the caller passes ``"cpu"``)."""
        return init_params(gen, self.param_descriptors(), dtype,
                           resolve_device(device))

    def n_params(self) -> int:
        return count_params(self.param_descriptors())

    # -- forward ------------------------------------------------------------

    def _embed(self, params, tokens):
        # gather, then cast: the same values as the JAX package's cast of
        # the whole table followed by the gather
        return params["embed"][tokens.long()].to(self.cfg.dtype)

    def _block_apply(self, p, x):
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x)
        x = x + attention(p["attn"], cfg.attn_config(), h,
                          use_kernel=cfg.use_flash_kernel)
        if cfg.d_ff > 0:
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        return x

    def _logits(self, params, hidden):
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return torch.einsum("bsd,dv->bsv", hidden, head.to(hidden.dtype))

    def forward(self, params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, V] in ``cfg.dtype``."""
        _no_mesh(mesh)
        x = self._embed(params, tokens)
        for p in params["layers"]:
            x = self._block_apply(p, x)
        return self._logits(params, rmsnorm(params["final_norm"], x))

    # -- serving ------------------------------------------------------------

    def _cache_len(self, max_seq: int) -> int:
        return min(self.cfg.window, max_seq) if self.cfg.window else max_seq

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda") -> list:
        """One ``KVCache`` per layer (the JAX package stacks them on a
        leading layers axis)."""
        device = resolve_device(device)
        return [init_kv_cache(batch, self._cache_len(max_seq),
                              self.cfg.attn_config(), dtype, device)
                for _ in range(self.cfg.n_layers)]

    def _block_decode(self, p, x, cache: KVCache):
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x)
        mix, new_cache = attention_decode(p["attn"], cfg.attn_config(), h,
                                          cache)
        x = x + mix
        if cfg.d_ff > 0:
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        return x, new_cache

    def decode_step(self, params, tokens: torch.Tensor, cache: list,
                    mesh=None):
        """tokens: [B] -> (logits [B, V] float32, new cache). One decode
        position. The caches' K/V are updated in place."""
        _no_mesh(mesh)
        x = self._embed(params, tokens)[:, None]               # [B, 1, D]
        new_cache = []
        for p, c in zip(params["layers"], cache):
            x, nc = self._block_decode(p, x, c)
            new_cache.append(nc)
        hidden = rmsnorm(params["final_norm"], x)
        return self._logits(params, hidden)[:, 0].to(torch.float32), new_cache

    def prefill(self, params, tokens: torch.Tensor, mesh=None):
        """Run the full prompt, build decode caches, return last logits.

        Attention caches hold the last ``window`` (or all) positions in
        bf16, sized to the prompt, with ``length`` = S. As in the JAX
        package, prefill attends through the einsum path (chunked when
        ``attn_chunk`` is set), never the flash kernel, and a decode step
        after it writes at slot S of an S-slot cache, which clamps onto the
        last entry (ROADMAP Queue C)."""
        _no_mesh(mesh)
        cfg = self.cfg
        b, s = tokens.shape
        acfg = cfg.attn_config()
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=x.device)
        caches = []
        for p in params["layers"]:
            h = rmsnorm(p["ln1"], x)
            q, k, v = _qkv(p["attn"], acfg, h, positions)
            mix = (_sdpa_chunked(q, k, v, acfg) if acfg.chunk > 0
                   else _sdpa(q, k, v, acfg))
            x = x + torch.einsum("bshk,hkd->bsd", mix,
                                 p["attn"]["wo"].to(x.dtype))
            cl = self._cache_len(s)
            # rolling-buffer alignment: slot = pos % cl
            last = torch.arange(s - cl, s, device=x.device)
            slots = last % cl
            kc = torch.zeros((b, cl, *k.shape[2:]), dtype=torch.bfloat16,
                             device=x.device)
            vc = torch.zeros_like(kc)
            kc[:, slots] = k[:, last].to(torch.bfloat16)
            vc[:, slots] = v[:, last].to(torch.bfloat16)
            caches.append(KVCache(k=kc, v=vc, length=torch.tensor(
                s, dtype=torch.int32, device=x.device)))
            if cfg.d_ff > 0:
                x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        hidden = rmsnorm(params["final_norm"], x[:, -1:])
        return self._logits(params, hidden)[:, 0].to(torch.float32), caches


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet: ROADMAP.md, Queue A, item 5 "
            "(telemetry, mesh and fleet)")
