"""Encoder-decoder backbone (whisper-small), the JAX package's
``models/encdec.py``. The audio conv frontend is a stub there and here: the
encoder takes precomputed frame embeddings [B, enc_seq, d_model].

As in the reference: RMSNorm instead of LayerNorm with bias, sinusoidal
positions on both sides, a non-gated GELU MLP. No attention call here asks
for the flash kernel: the reference's never do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from .layers import (AttnConfig, KVCache, _qkv, _sdpa, attention,
                     attention_decode, attention_params, init_kv_cache, mlp,
                     mlp_params, rmsnorm, rmsnorm_params)
from .lm import _no_mesh, token_nll
from .spec import P, count_params, init_params

F32 = torch.float32


def sinusoidal(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """[..., d] sin | cos embeddings of ``positions``, computed in float32
    as the reference does, then cast to ``dtype``."""
    half = d // 2
    ar = torch.arange(half, device=positions.device)
    freqs = torch.exp(-ar / torch.tensor(half, dtype=F32, device=ar.device)
                      * torch.tensor(math.log(10_000.0), dtype=F32,
                                     device=ar.device))
    ang = positions[..., None].to(F32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


class EncDecLM:
    """Whisper-style encoder-decoder; mirrors ``DecoderLM``'s public API."""

    class Cache(NamedTuple):
        self_kv: list          # a KVCache a decoder layer
        cross_kv: list         # a decoder layer's (k, v) of the encoder output
        length: torch.Tensor   # 0-d int32

    def __init__(self, cfg):
        self.cfg = cfg  # ModelConfig with enc_layers / enc_seq set

    def _attn_cfg(self, causal: bool) -> AttnConfig:
        c = self.cfg.attn_config(causal=causal)
        return c._replace(use_rope=False)  # absolute sinusoidal positions

    def _enc_block_desc(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": rmsnorm_params(cfg.d_model),
            "attn": attention_params(self._attn_cfg(False)),
            "ln2": rmsnorm_params(cfg.d_model),
            "ffn": mlp_params(cfg.d_model, cfg.d_ff, gated=False),
        }

    def _dec_block_desc(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": rmsnorm_params(cfg.d_model),
            "self_attn": attention_params(self._attn_cfg(True)),
            "ln_x": rmsnorm_params(cfg.d_model),
            "cross_attn": attention_params(self._attn_cfg(False)),
            "ln2": rmsnorm_params(cfg.d_model),
            "ffn": mlp_params(cfg.d_model, cfg.d_ff, gated=False),
        }

    def param_descriptors(self) -> dict:
        cfg = self.cfg
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed")),
            "enc_norm": rmsnorm_params(cfg.d_model),
            "final_norm": rmsnorm_params(cfg.d_model),
            "lm_head": P((cfg.d_model, cfg.vocab), ("embed", "vocab")),
            "encoder": [self._enc_block_desc() for _ in range(cfg.enc_layers)],
            "decoder": [self._dec_block_desc() for _ in range(cfg.n_layers)],
        }

    def init(self, gen: torch.Generator, dtype=torch.float32, device="cuda"):
        """Parameters drawn from ``gen``, placed on ``device`` (the card
        unless the caller passes ``"cpu"``)."""
        return init_params(gen, self.param_descriptors(), dtype,
                           resolve_device(device))

    def n_params(self) -> int:
        return count_params(self.param_descriptors())

    n_active_params = n_params

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.cfg.dtype)

    def _logits(self, params, hidden):
        return torch.einsum("bsd,dv->bsv", hidden,
                            params["lm_head"].to(hidden.dtype))

    # -- encoder -------------------------------------------------------------

    def encode(self, params, frames: torch.Tensor, mesh=None) -> torch.Tensor:
        """frames: [B, S_enc, D] (stub frontend output) -> [B, S_enc, D]."""
        _no_mesh(mesh)
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        x = x + sinusoidal(torch.arange(x.shape[1], device=x.device),
                           cfg.d_model, cfg.dtype)
        for p in params["encoder"]:
            x = x + attention(p["attn"], self._attn_cfg(False),
                              rmsnorm(p["ln1"], x))
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        return rmsnorm(params["enc_norm"], x)

    # -- decoder -------------------------------------------------------------

    def _cross_kv(self, p, enc_out):
        _, ek, ev = _qkv(p["cross_attn"], self._attn_cfg(False), enc_out,
                         torch.arange(enc_out.shape[1], device=enc_out.device))
        return ek, ev

    def _dec_block(self, p, x, enc_out, positions):
        x = x + attention(p["self_attn"], self._attn_cfg(True),
                          rmsnorm(p["ln1"], x), positions)
        h = rmsnorm(p["ln_x"], x)
        x = x + attention(p["cross_attn"], self._attn_cfg(False), h,
                          positions, kv=self._cross_kv(p, enc_out))
        return x + mlp(p["ffn"], rmsnorm(p["ln2"], x))

    def _start(self, params, tokens):
        """Token embeddings plus their sinusoidal positions."""
        x = self._embed(params, tokens)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + sinusoidal(pos, self.cfg.d_model, self.cfg.dtype), pos

    def forward(self, params, batch_or_tokens, mesh=None, frames=None):
        """tokens [B, S] (with ``frames``) or {"tokens", "frames"} ->
        logits [B, S, V] in ``cfg.dtype``."""
        if isinstance(batch_or_tokens, dict):
            tokens = batch_or_tokens["tokens"]
            frames = batch_or_tokens["frames"]
        else:
            tokens = batch_or_tokens
        enc_out = self.encode(params, frames, mesh)
        x, pos = self._start(params, tokens)
        for p in params["decoder"]:
            x = self._dec_block(p, x, enc_out, pos)
        return self._logits(params, rmsnorm(params["final_norm"], x))

    def loss(self, params, batch: dict, mesh=None):
        """Next-token cross entropy over {"tokens", "labels", "frames"};
        (loss, {"nll", "aux"}) with aux 0, as in the reference."""
        nll = token_nll(self.forward(params, batch, mesh), batch["labels"])
        return nll, {"nll": nll,
                     "aux": torch.zeros((), dtype=F32, device=nll.device)}

    # -- serving --------------------------------------------------------------

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda") -> "EncDecLM.Cache":
        """Empty self-attention caches and zero cross K/V (the encoder
        output enters through ``prefill``)."""
        cfg = self.cfg
        device = resolve_device(device)
        self_kv = [init_kv_cache(batch, max_seq, self._attn_cfg(True), dtype,
                                 device) for _ in range(cfg.n_layers)]
        shape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cross = [(torch.zeros(shape, dtype=dtype, device=device),) * 2
                 for _ in range(cfg.n_layers)]
        return EncDecLM.Cache(self_kv=self_kv, cross_kv=cross,
                              length=torch.zeros((), dtype=torch.int32,
                                                 device=device))

    def prefill(self, params, tokens, mesh=None, frames=None):
        """Encode and consume the prompt; returns (last logits, cache). The
        self-attention caches are the prompt's bf16 K/V, sized to the
        prompt, as in the reference: the caller pads them for further
        decoding."""
        s = tokens.shape[1]
        enc_out = self.encode(params, frames, mesh)
        x, pos = self._start(params, tokens)
        acfg = self._attn_cfg(True)
        length = torch.tensor(s, dtype=torch.int32, device=x.device)
        self_kv, cross_kv = [], []
        for p in params["decoder"]:
            q, k, v = _qkv(p["self_attn"], acfg, rmsnorm(p["ln1"], x), pos)
            x = x + torch.einsum("bshk,hkd->bsd", _sdpa(q, k, v, acfg),
                                 p["self_attn"]["wo"].to(x.dtype))
            self_kv.append(KVCache(k=k.to(torch.bfloat16),
                                   v=v.to(torch.bfloat16), length=length))
            ek, ev = self._cross_kv(p, enc_out)
            x = x + attention(p["cross_attn"], self._attn_cfg(False),
                              rmsnorm(p["ln_x"], x), pos, kv=(ek, ev))
            cross_kv.append((ek.to(torch.bfloat16), ev.to(torch.bfloat16)))
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        hidden = rmsnorm(params["final_norm"], x[:, -1:])
        logits = self._logits(params, hidden)[:, 0]
        return logits.to(F32), EncDecLM.Cache(self_kv=self_kv,
                                              cross_kv=cross_kv, length=length)

    def decode_step(self, params, tokens, cache, mesh=None, *,
                    use_kernel: bool = False):
        """tokens: [B] -> (logits [B, V] float32, new cache). The
        self-attention K/V are written in place; the position is the
        cache's one ``length``. ``use_kernel`` sends the self-attention to
        the GQA decode kernel; the cross-attention goes through
        ``attention(..., kv=)``, as in the reference."""
        _no_mesh(mesh)
        cfg = self.cfg
        x = self._embed(params, tokens)[:, None]
        x = x + sinusoidal(cache.length[None], cfg.d_model, cfg.dtype)[None]
        pos = cache.length.reshape(1, 1).expand(x.shape[0], 1)
        new_self = []
        for p, kv, (ek, ev) in zip(params["decoder"], cache.self_kv,
                                   cache.cross_kv):
            mix, nkv = attention_decode(
                p["self_attn"], self._attn_cfg(True), rmsnorm(p["ln1"], x),
                kv._replace(length=cache.length), use_kernel=use_kernel)
            x = x + mix
            new_self.append(nkv)
            x = x + attention(p["cross_attn"], self._attn_cfg(False),
                              rmsnorm(p["ln_x"], x), pos,
                              kv=(ek.to(x.dtype), ev.to(x.dtype)))
            x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
        hidden = rmsnorm(params["final_norm"], x)
        logits = self._logits(params, hidden)[:, 0]
        return logits.to(F32), EncDecLM.Cache(
            self_kv=new_self, cross_kv=cache.cross_kv,
            length=cache.length + 1)
