"""Encoder-decoder backbone (whisper-small), the JAX package's
``models/encdec.py``. The audio conv frontend is a stub there and here: the
encoder takes precomputed frame embeddings [B, enc_seq, d_model].

As in the reference: RMSNorm instead of LayerNorm with bias, sinusoidal
positions on both sides, a non-gated GELU MLP. No attention call here asks
for the flash kernel: the reference's never do.

Over a ``device.Mesh`` every entry point splits the batch into
data-parallel ranks (``spec.batch_ranks``), each gathering the weights onto
its device and computing its rows there; the decoder's self-attention
caches are laid out per ``cache_shardings`` and written and read shard by
shard (``layers.attention_decode``), as ``DecoderLM``'s are.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from .layers import (AttnConfig, KVCache, _qkv, _sdpa, attention,
                     attention_decode, attention_params, init_kv_cache, mlp,
                     mlp_params, rmsnorm, rmsnorm_params)
from .lm import (_cat_rows, _mesh_of, _place_like, _rows,
                 combine_rank_losses, token_nll)
from .spec import (P, abstract_params, batch_ranks, count_params, gather,
                   init_params, local_tree, logical_constraint, map_leaves,
                   param_shardings, param_specs, place_tree,
                   shardings_for_tree)

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

    def abstract_params(self, dtype=torch.float32):
        """The parameters as ``meta`` tensors (nothing allocated)."""
        return abstract_params(self.param_descriptors(), dtype)

    def param_specs(self, mesh):
        return param_specs(self.param_descriptors(), mesh)

    def param_shardings(self, mesh, drop_axes: tuple = ()):
        return param_shardings(self.param_descriptors(), mesh, drop_axes)

    def n_params(self) -> int:
        return count_params(self.param_descriptors())

    n_active_params = n_params

    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.cfg.dtype)

    def _logits(self, params, hidden):
        return torch.einsum("bsd,dv->bsv", hidden,
                            params["lm_head"].to(hidden.dtype))

    # -- encoder -------------------------------------------------------------

    def _ranks(self, mesh, batch: int) -> list:
        return batch_ranks(mesh, batch)

    def encode(self, params, frames: torch.Tensor, mesh=None) -> torch.Tensor:
        """frames: [B, S_enc, D] (stub frontend output) -> [B, S_enc, D]."""
        mesh = _mesh_of(mesh)
        if mesh is not None:
            outs = [self.encode(local_tree(params, r.device),
                                frames[r.lo:r.hi].to(r.device))
                    for r in batch_ranks(mesh, frames.shape[0])]
            outs = logical_constraint(outs, ("batch", "seq", None), mesh)
            return torch.cat([o.to(mesh.devices[0]) for o in outs])
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
        mesh = _mesh_of(mesh)
        if mesh is not None:
            outs = [self.forward(local_tree(params, r.device),
                                 tokens[r.lo:r.hi].to(r.device),
                                 frames=frames[r.lo:r.hi].to(r.device))
                    for r in batch_ranks(mesh, tokens.shape[0])]
            outs = logical_constraint(outs, ("batch", "seq", "vocab"), mesh)
            return torch.cat([o.to(mesh.devices[0]) for o in outs])
        enc_out = self.encode(params, frames)
        x, pos = self._start(params, tokens)
        for p in params["decoder"]:
            x = self._dec_block(p, x, enc_out, pos)
        return self._logits(params, rmsnorm(params["final_norm"], x))

    def loss(self, params, batch: dict, mesh=None):
        """Next-token cross entropy over {"tokens", "labels", "frames"};
        (loss, {"nll", "aux"}) with aux 0, as in the reference. Over a mesh,
        the ranks' means (``rank_loss``) weighted by their rows, summed in
        rank order."""
        mesh = _mesh_of(mesh)
        if mesh is not None:
            ranks = batch_ranks(mesh, batch["tokens"].shape[0])
            return combine_rank_losses(
                self.cfg, [self.rank_loss(params, batch, mesh, r)
                           for r in ranks], ranks[0].device)
        nll = token_nll(self.forward(params, batch), batch["labels"])
        return nll, {"nll": nll,
                     "aux": torch.zeros((), dtype=F32, device=nll.device)}

    def rank_loss(self, params, batch: dict, mesh, rank) -> tuple:
        """Data-parallel rank ``rank``'s part of ``loss``: its rows' mean
        nll weighted by its share of the batch, and a zero aux."""
        n = batch["tokens"].shape[0]
        rows = {k: v[rank.lo:rank.hi].to(rank.device)
                for k, v in batch.items()}
        logits = self.forward(local_tree(params, rank.device), rows)
        nll = token_nll(logits, rows["labels"]) * ((rank.hi - rank.lo) / n)
        return nll, torch.zeros((), dtype=F32, device=rank.device)

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

    def cache_axes(self) -> "EncDecLM.Cache":
        cfg = self.cfg
        kv_axes = KVCache(k=("batch", "kv_seq", "kv_heads", None),
                          v=("batch", "kv_seq", "kv_heads", None), length=())
        cross = (("batch", None, "kv_heads", None),) * 2
        return EncDecLM.Cache(self_kv=[kv_axes] * cfg.n_layers,
                              cross_kv=[cross] * cfg.n_layers, length=())

    def cache_shardings(self, mesh, batch: int, max_seq: int,
                        dtype=torch.bfloat16) -> "EncDecLM.Cache":
        shapes = self.init_cache(batch, max_seq, dtype, device="meta")
        return shardings_for_tree(shapes, self.cache_axes(), mesh)

    def prefill(self, params, tokens, mesh=None, frames=None):
        """Encode and consume the prompt; returns (last logits, cache). The
        self-attention caches are the prompt's bf16 K/V, sized to the
        prompt, as in the reference: the caller pads them for further
        decoding. Over a mesh each rank runs its rows and the cache is laid
        out per ``cache_axes``."""
        mesh = _mesh_of(mesh)
        if mesh is not None:
            first = mesh.devices[0]
            parts = [self.prefill(local_tree(params, r.device),
                                  tokens[r.lo:r.hi].to(r.device),
                                  frames=frames[r.lo:r.hi].to(r.device))
                     for r in batch_ranks(mesh, tokens.shape[0])]
            cache = map_leaves(lambda *xs: _cat_rows(xs, first),
                               *[c for _, c in parts])
            cache = place_tree(cache, shardings_for_tree(
                cache, self.cache_axes(), mesh))
            logits = torch.cat([lg.to(first) for lg, _ in parts])
            return logits, cache
        s = tokens.shape[1]
        enc_out = self.encode(params, frames)
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
        ``attention(..., kv=)``, as in the reference. Over a mesh each rank
        decodes its rows against the cache ``cache_shardings`` lays out."""
        mesh = _mesh_of(mesh)
        if mesh is not None:
            return self._mesh_decode(params, tokens, cache, mesh, use_kernel)
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

    def _mesh_decode(self, params, tokens, cache, mesh, use_kernel):
        cfg = self.cfg
        first = mesh.devices[0]
        logits, lengths = [], None
        for r in batch_ranks(mesh, tokens.shape[0]):
            p_all = local_tree({k: params[k] for k in
                                ("embed", "final_norm", "lm_head")},
                               r.device)
            length = gather(cache.length, r.device)
            x = self._embed(p_all, tokens[r.lo:r.hi].to(r.device))[:, None]
            x = x + sinusoidal(length[None], cfg.d_model, cfg.dtype)[None]
            pos = length.reshape(1, 1).expand(x.shape[0], 1)
            for p, kv, (ek, ev) in zip(params["decoder"], cache.self_kv,
                                       cache.cross_kv):
                p = local_tree(p, r.device)
                mix, _ = attention_decode(
                    p["self_attn"], self._attn_cfg(True),
                    rmsnorm(p["ln1"], x), kv._replace(length=length),
                    use_kernel=use_kernel, mesh=mesh, row0=r.lo)
                x = x + mix
                ek, ev = _rows(ek, r), _rows(ev, r)
                x = x + attention(p["cross_attn"], self._attn_cfg(False),
                                  rmsnorm(p["ln_x"], x), pos,
                                  kv=(ek.to(x.dtype), ev.to(x.dtype)))
                x = x + mlp(p["ffn"], rmsnorm(p["ln2"], x))
            hidden = rmsnorm(p_all["final_norm"], x)
            logits.append(self._logits(p_all, hidden)[:, 0].to(F32))
            if lengths is None:
                lengths = (length + 1).to(first)
        new_self = [kv._replace(length=_place_like(lengths, kv.length))
                    for kv in cache.self_kv]
        return torch.cat([lg.to(first) for lg in logits]), EncDecLM.Cache(
            self_kv=new_self, cross_kv=cache.cross_kv,
            length=_place_like(lengths, cache.length))
