"""Decoder-only LM covering the dense / moe / hybrid / ssm / vlm families of
the JAX package's ``models/lm.py``.

Block structure by family:
  dense/vlm : x += attn(ln1 x);             x += mlp(ln2 x)
  moe       : x += attn(ln1 x);             x += moe(ln2 x)
  hybrid    : x += attn(ln1 x) + ssm(ln1 x) x += mlp(ln2 x)   (hymba parallel)
  ssm       : x += mlstm(ln1 x) | slstm(ln1 x)                (no FFN, d_ff=0)

``DecoderLM`` is stateless, as in the JAX package: ``init`` returns the
parameters (a ``Params`` module tree) and every method takes them first.
Every stack is a list of per-layer ``Params`` here, and the reference's
``lax.scan`` over a homogeneous stack a Python loop; the reference stacks a
homogeneous stack's parameters and caches on a leading layers axis and keeps
a heterogeneous one (xLSTM) as a list. ``loss`` is the training objective,
with each block recomputed in the backward pass under ``cfg.remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from . import moe as moe_lib
from . import ssm as ssm_lib
from . import xlstm as xlstm_lib
from .layers import (_ROADMAP_MESH, AttnConfig, KVCache, _qkv, _sdpa,
                     _sdpa_chunked, attention, attention_decode,
                     attention_params, init_kv_cache, mlp, mlp_params, rmsnorm,
                     rmsnorm_params)
from .spec import P, count_params, init_params


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
    window: int = 0             # sliding-window attention (hybrid)
    gated_mlp: bool = True
    n_experts: int = 0
    moe_top_k: int = 0
    moe_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    ssm_state: int = 0
    enc_layers: int = 0         # audio (whisper) encoder depth
    enc_seq: int = 1500         # audio frames after the (stubbed) frontend
    scan_layers: bool = True
    remat: bool = True          # recompute each block in the backward pass
    attn_chunk: int = 0         # chunked attention block (0 = off)
    moe_local_dispatch: bool = False
    dtype: Any = torch.bfloat16  # activation/compute dtype
    use_flash_kernel: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can serve arbitrarily long contexts with O(1)/O(window) state."""
        return self.family in ("hybrid", "ssm")

    def attn_config(self, causal=True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            qk_norm=self.qk_norm, causal=causal, window=self.window,
            rope_theta=self.rope_theta, chunk=self.attn_chunk,
        )

    def ssm_config(self) -> ssm_lib.SSMConfig:
        return ssm_lib.SSMConfig(
            d_model=self.d_model, d_inner=self.d_model,
            n_heads=self.n_heads, state=self.ssm_state,
        )

    def xlstm_config(self) -> xlstm_lib.XLSTMConfig:
        return xlstm_lib.XLSTMConfig(d_model=self.d_model,
                                     n_heads=self.n_heads)

    def moe_config(self) -> moe_lib.MoEConfig:
        return moe_lib.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.moe_top_k, capacity_factor=self.moe_capacity_factor,
        )


class DecoderLM:
    """Decoder LM over a ``Params`` tree; every method is a plain function
    of its arguments. ``cfg.remat`` (activation checkpointing) acts in
    ``loss`` only, where a backward pass follows."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        if cfg.family == "ssm":
            self.layer_types = tuple(
                "mlstm" if i % 2 == 0 else "slstm" for i in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            self.layer_types = ("hybrid",) * cfg.n_layers
        else:
            self.layer_types = ("attn",) * cfg.n_layers

    # -- parameters ---------------------------------------------------------

    def _block_descriptors(self, ltype: str) -> dict:
        cfg = self.cfg
        d: dict = {"ln1": rmsnorm_params(cfg.d_model)}
        if ltype in ("attn", "hybrid"):
            d["attn"] = attention_params(cfg.attn_config())
        if ltype == "hybrid":
            d["ssm"] = ssm_lib.ssm_params(cfg.ssm_config())
        if ltype == "mlstm":
            d["mlstm"] = xlstm_lib.mlstm_params(cfg.xlstm_config())
        if ltype == "slstm":
            d["slstm"] = xlstm_lib.slstm_params(cfg.xlstm_config())
        if cfg.d_ff > 0:
            d["ln2"] = rmsnorm_params(cfg.d_model)
            if cfg.family == "moe":
                d["ffn"] = moe_lib.moe_params(cfg.moe_config())
            else:
                d["ffn"] = mlp_params(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        return d

    def param_descriptors(self) -> dict:
        cfg = self.cfg
        tree: dict = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=1.0),
            "final_norm": rmsnorm_params(cfg.d_model),
            "layers": [self._block_descriptors(t) for t in self.layer_types],
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

    def n_active_params(self) -> int:
        """Active params per token (MoE discounts inactive experts)."""
        total = self.n_params()
        cfg = self.cfg
        if cfg.family != "moe":
            return total
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = cfg.n_layers * (cfg.n_experts - cfg.moe_top_k) * per_expert
        return total - inactive

    # -- forward ------------------------------------------------------------

    def _embed(self, params, tokens):
        # gather, then cast: the same values as the JAX package's cast of
        # the whole table followed by the gather
        return params["embed"][tokens.long()].to(self.cfg.dtype)

    def _ffn(self, p, x):
        """x += the block's feed-forward; (x, MoE aux loss)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.d_ff > 0:
            h2 = rmsnorm(p["ln2"], x)
            if cfg.family == "moe":
                out = self._moe(p["ffn"], h2)
                x, aux = x + out.y, out.aux_loss
            else:
                x = x + mlp(p["ffn"], h2)
        return x, aux

    def _block_apply(self, ltype: str, p, x):
        """One block of the full-sequence forward: (x, MoE aux loss)."""
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x)
        if ltype == "attn":
            mix = attention(p["attn"], cfg.attn_config(), h,
                            use_kernel=cfg.use_flash_kernel)
        elif ltype == "hybrid":
            mix = attention(p["attn"], cfg.attn_config(), h,
                            use_kernel=cfg.use_flash_kernel)
            mix = mix + ssm_lib.ssm(p["ssm"], cfg.ssm_config(), h)
        elif ltype == "mlstm":
            mix = xlstm_lib.mlstm(p["mlstm"], cfg.xlstm_config(), h)
        else:  # slstm
            mix, _ = xlstm_lib.slstm(p["slstm"], cfg.xlstm_config(), h)
        return self._ffn(p, x + mix)

    def _moe(self, p, h, mesh=None):
        """The MoE layer; expert-parallel dispatch over a mesh raises."""
        cfg = self.cfg
        if cfg.moe_local_dispatch and mesh is not None:
            return moe_lib.moe_local(p, cfg.moe_config(), h, mesh)
        return moe_lib.moe(p, cfg.moe_config(), h)

    def _logits(self, params, hidden):
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return torch.einsum("bsd,dv->bsv", hidden, head.to(hidden.dtype))

    def _backbone(self, params, x, remat: bool = False):
        """Embeddings -> final norm: (hidden, the blocks' summed MoE aux
        loss). With ``remat`` each block keeps only its input for the
        backward pass and runs again there, as the JAX package's
        ``jax.checkpoint(policy=nothing_saveable)`` does."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for ltype, p in zip(self.layer_types, params["layers"]):
            if remat:
                x, a = checkpoint(self._block_apply, ltype, p, x,
                                  use_reentrant=False)
            else:
                x, a = self._block_apply(ltype, p, x)
            aux = aux + a
        return rmsnorm(params["final_norm"], x), aux

    def forward(self, params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, V] in ``cfg.dtype``."""
        _no_mesh(mesh)
        hidden, _ = self._backbone(params, self._embed(params, tokens))
        return self._logits(params, hidden)

    def loss(self, params, batch: dict, mesh=None) -> tuple:
        """Next-token cross entropy (+ the MoE aux loss at ``moe_aux_coef /
        n_layers``). batch: tokens/labels [B, S]. Returns (loss, {"nll",
        "aux"}), 0-d float32 tensors.

        The embedding table is cast to ``cfg.dtype`` whole and then
        gathered, in the JAX package's order: the values equal
        ``_embed``'s, and in bf16 the table's gradient accumulates
        repeated tokens in bf16 as the reference's does."""
        _no_mesh(mesh)
        cfg = self.cfg
        x = params["embed"].to(cfg.dtype)[batch["tokens"].long()]
        hidden, aux = self._backbone(
            params, x, remat=cfg.remat and torch.is_grad_enabled())
        nll = token_nll(self._logits(params, hidden), batch["labels"])
        loss = nll
        if cfg.family == "moe":
            loss = loss + cfg.moe_aux_coef * aux / cfg.n_layers
        return loss, {"nll": nll, "aux": aux}

    # -- serving ------------------------------------------------------------

    def _cache_len(self, max_seq: int) -> int:
        return min(self.cfg.window, max_seq) if self.cfg.window else max_seq

    def _layer_cache(self, ltype: str, batch: int, max_seq: int, dtype,
                     device):
        cfg = self.cfg
        if ltype == "mlstm":
            return xlstm_lib.init_mlstm_cache(batch, cfg.xlstm_config(),
                                              device)
        if ltype == "slstm":
            return xlstm_lib.init_slstm_state(batch, cfg.xlstm_config(),
                                              device)
        kv = init_kv_cache(batch, self._cache_len(max_seq),
                           cfg.attn_config(), dtype, device)
        if ltype == "attn":
            return kv
        return {"attn": kv, "ssm": ssm_lib.init_ssm_cache(
            batch, cfg.ssm_config(), dtype, device)}

    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device="cuda") -> list:
        """One cache a layer: a ``KVCache`` (attn), a dict of ``KVCache``
        and ``SSMCache`` (hybrid), an ``MLSTMCache`` or an ``SLSTMState``
        (the JAX package stacks a homogeneous stack's on a layers axis)."""
        device = resolve_device(device)
        return [self._layer_cache(t, batch, max_seq, dtype, device)
                for t in self.layer_types]

    def _block_decode(self, ltype: str, p, x, cache, use_kernel=False):
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x)
        if ltype == "attn":
            mix, new_cache = attention_decode(p["attn"], cfg.attn_config(), h,
                                              cache, use_kernel=use_kernel)
        elif ltype == "hybrid":
            mix_a, kv = attention_decode(p["attn"], cfg.attn_config(), h,
                                         cache["attn"], use_kernel=use_kernel)
            mix_s, sc = ssm_lib.ssm_decode(p["ssm"], cfg.ssm_config(), h,
                                           cache["ssm"])
            mix, new_cache = mix_a + mix_s, {"attn": kv, "ssm": sc}
        elif ltype == "mlstm":
            mix, new_cache = xlstm_lib.mlstm_decode(
                p["mlstm"], cfg.xlstm_config(), h, cache)
        else:
            xcfg = cfg.xlstm_config()
            wx = torch.einsum("bsd,de->bse", h,
                              p["slstm"]["w_gates"].to(h.dtype))
            new_cache = xlstm_lib._slstm_cell(p["slstm"], xcfg, cache,
                                              wx[:, 0])
            mix = xlstm_lib._slstm_out(p["slstm"], xcfg,
                                       new_cache.h[:, None], x.dtype)
        x, _ = self._ffn(p, x + mix)
        return x, new_cache

    def decode_step(self, params, tokens: torch.Tensor, cache: list,
                    mesh=None, *, use_kernel: bool = False):
        """tokens: [B] -> (logits [B, V] float32, new cache). One decode
        position. Attention caches' K/V are updated in place; recurrent
        states are new tensors. ``use_kernel`` sends each attention layer to
        the GQA decode kernel (its plain version on the CPU); the JAX
        package's decode step always takes the einsum lane."""
        _no_mesh(mesh)
        x = self._embed(params, tokens)[:, None]               # [B, 1, D]
        new_cache = []
        for ltype, p, c in zip(self.layer_types, params["layers"], cache):
            x, nc = self._block_decode(ltype, p, x, c, use_kernel)
            new_cache.append(nc)
        hidden = rmsnorm(params["final_norm"], x)
        return self._logits(params, hidden)[:, 0].to(torch.float32), new_cache

    def _prefill_attention(self, p, h, s):
        """The prompt's attention through the einsum path, and its bf16
        cache of the last ``window`` (or all) positions."""
        acfg = self.cfg.attn_config()
        b = h.shape[0]
        q, k, v = _qkv(p, acfg, h, torch.arange(s, device=h.device))
        mix = (_sdpa_chunked(q, k, v, acfg) if acfg.chunk > 0
               else _sdpa(q, k, v, acfg))
        mix = torch.einsum("bshk,hkd->bsd", mix, p["wo"].to(h.dtype))
        cl = self._cache_len(s)
        # rolling-buffer alignment: slot = pos % cl
        last = torch.arange(s - cl, s, device=h.device)
        slots = last % cl
        kc = torch.zeros((b, cl, *k.shape[2:]), dtype=torch.bfloat16,
                         device=h.device)
        vc = torch.zeros_like(kc)
        kc[:, slots] = k[:, last].to(torch.bfloat16)
        vc[:, slots] = v[:, last].to(torch.bfloat16)
        return mix, KVCache(k=kc, v=vc, length=torch.tensor(
            s, dtype=torch.int32, device=h.device))

    def prefill(self, params, tokens: torch.Tensor, mesh=None):
        """Run the full prompt, build decode caches, return last logits.

        Attention caches hold the last ``window`` (or all) positions in
        bf16, sized to the prompt, with ``length`` = S; the hybrid SSM cache
        holds the final state and the last ``conv_kernel - 1`` inputs (bf16),
        the mLSTM cache its final state and the sLSTM its final state. As in
        the JAX package, prefill attends through the einsum path (chunked
        when ``attn_chunk`` is set), never the flash kernel, and a decode
        step after an unwindowed prefill writes at slot S of an S-slot
        cache, which clamps onto the last entry (ROADMAP Queue C)."""
        _no_mesh(mesh)
        cfg = self.cfg
        s = tokens.shape[1]
        x = self._embed(params, tokens)
        caches = []
        for ltype, p in zip(self.layer_types, params["layers"]):
            h = rmsnorm(p["ln1"], x)
            if ltype in ("attn", "hybrid"):
                mix, cache = self._prefill_attention(p["attn"], h, s)
                if ltype == "hybrid":
                    scfg = cfg.ssm_config()
                    mix_s, h_fin, xin = ssm_lib.ssm_mix(p["ssm"], scfg, h)
                    mix = mix + mix_s
                    cache = {"attn": cache, "ssm": ssm_lib.SSMCache(
                        h=h_fin, conv=xin[:, -(scfg.conv_kernel - 1):]
                        .to(torch.bfloat16))}
            elif ltype == "mlstm":
                mix, h_fin = xlstm_lib.mlstm_mix(p["mlstm"],
                                                 cfg.xlstm_config(), h)
                cache = xlstm_lib.MLSTMCache(h=h_fin)
            else:  # slstm
                mix, cache = xlstm_lib.slstm(p["slstm"], cfg.xlstm_config(), h)
            x, _ = self._ffn(p, x + mix)
            caches.append(cache)
        hidden = rmsnorm(params["final_norm"], x[:, -1:])
        return self._logits(params, hidden)[:, 0].to(torch.float32), caches


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits [B, S, V] taken to
    float32, ``log_softmax``, the label's entry."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"a device mesh is not ported yet: {_ROADMAP_MESH}")
