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

Over a ``device.Mesh`` (``mesh=`` of ``forward``, ``loss``, ``prefill`` and
``decode_step``) the batch splits into data-parallel ranks
(``spec.batch_ranks``), each computing on its rows on its own device. What
the JAX package leaves to GSPMD is done one way here: leaves stay stored
per their resolved spec (``param_shardings``, ``cache_shardings``), each
rank gathers the weight shards a block needs onto its device, computes, and
drops the gathered copies; a layer's arithmetic is not split over
``model`` (the compiler's choice in JAX, on which results do not depend).
The activation is laid out by its logical axes (``logical_constraint``)
where the ranks' rows are placed and where their logits are joined; within
a block a rank holds only its rows, which is the layout the JAX package
constrains its blocks' outputs to.
The JAX package's explicit per-rank code has its counterparts: the
sequence-sharded KV cache's owner write and flash-decode
(``layers.attention_decode``) and expert-parallel dispatch
(``moe.moe_local_rank`` under ``cfg.moe_local_dispatch``). A MoE model with
the global dispatch needs every rank's tokens at each MoE layer (its
routing and capacity are over the whole batch, an all-gather in GSPMD), so
it computes as one rank with every row. A mesh of one device is the
unsharded path, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import Mesh, resolve_device
from . import moe as moe_lib
from . import ssm as ssm_lib
from . import xlstm as xlstm_lib
from .layers import (AttnConfig, KVCache, _qkv, _sdpa, _sdpa_chunked,
                     attention, attention_decode, attention_params,
                     init_kv_cache, mlp, mlp_params, rmsnorm, rmsnorm_params)
from .spec import (P, Rank, Sharded, abstract_params, batch_ranks,
                   count_params, gather, init_params, local_tree,
                   logical_constraint, map_leaves, param_shardings,
                   param_specs, place_tree, put, shardings_for_tree)


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

    def abstract_params(self, dtype=torch.float32):
        """The parameters as ``meta`` tensors (nothing allocated)."""
        return abstract_params(self.param_descriptors(), dtype)

    def param_specs(self, mesh):
        return param_specs(self.param_descriptors(), mesh)

    def param_shardings(self, mesh, drop_axes: tuple = ()):
        return param_shardings(self.param_descriptors(), mesh, drop_axes)

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

    def _embed(self, params, tokens, cast_table: bool = False):
        """Token embeddings where the table is (a ``Sharded`` table
        gathered onto the tokens' device). Gather, then cast: the same
        values as the JAX package's cast of the whole table followed by the
        gather, which ``cast_table`` (``loss``'s order, for the bf16
        gradient) keeps."""
        table = params["embed"]
        if isinstance(table, Sharded):
            table = table.gather(tokens.device)
        tokens = tokens.to(table.device).long()
        if cast_table:
            return table.to(self.cfg.dtype)[tokens]
        return table[tokens].to(self.cfg.dtype)

    def _ffn(self, p, x, ctx=None):
        """x += the block's feed-forward; (x, MoE aux loss). ``ctx``: the
        data-parallel rank over a mesh computing these rows, or None."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.d_ff > 0:
            h2 = rmsnorm(p["ln2"], x)
            if cfg.family == "moe":
                out = (self._moe(p["ffn"], h2) if ctx is None else
                       self._moe(p["ffn"], h2, ctx.mesh, ctx.rank.coords))
                x, aux = x + out.y, out.aux_loss
            else:
                x = x + mlp(p["ffn"], h2)
        return x, aux

    def _mix(self, ltype: str, p, x):
        """A block's token mixing (attention, SSM, mLSTM or sLSTM) of the
        full-sequence forward."""
        cfg = self.cfg
        h = rmsnorm(p["ln1"], x)
        if ltype == "attn":
            return attention(p["attn"], cfg.attn_config(), h,
                             use_kernel=cfg.use_flash_kernel)
        if ltype == "hybrid":
            mix = attention(p["attn"], cfg.attn_config(), h,
                            use_kernel=cfg.use_flash_kernel)
            return mix + ssm_lib.ssm(p["ssm"], cfg.ssm_config(), h)
        if ltype == "mlstm":
            return xlstm_lib.mlstm(p["mlstm"], cfg.xlstm_config(), h)
        return xlstm_lib.slstm(p["slstm"], cfg.xlstm_config(), h)[0]

    def _block_apply(self, ltype: str, p, x, ctx=None):
        """One block of the full-sequence forward: (x, MoE aux loss). Over a
        mesh the rank gathers the block's weights onto its device here, so
        that under remat the gathered copies are dropped between the
        passes."""
        if ctx is not None:
            p = local_tree(p, ctx.rank.device)
        return self._ffn(p, x + self._mix(ltype, p, x), ctx)

    def _moe(self, p, h, mesh=None, coords=None):
        """The MoE layer: expert-parallel over ``mesh`` with
        ``cfg.moe_local_dispatch`` (``moe_local`` of all of h, or with a
        data-parallel rank's ``coords`` ``moe_local_rank`` of its rows),
        else the global dispatch."""
        cfg = self.cfg
        if cfg.moe_local_dispatch and mesh is not None:
            _check_mesh(mesh)
            if coords is None:
                return moe_lib.moe_local(p, cfg.moe_config(), h, mesh)
            if _local_dispatch(cfg, mesh):
                return moe_lib.moe_local_rank(p, cfg.moe_config(), h, mesh,
                                              coords)
        return moe_lib.moe(p, cfg.moe_config(), h)

    def _logits(self, params, hidden):
        """The head (a ``Sharded`` one gathered onto hidden's device)."""
        tied = self.cfg.tie_embeddings
        w = params["embed" if tied else "lm_head"]
        if isinstance(w, Sharded):
            w = w.gather(hidden.device)
        return torch.einsum("bsd,dv->bsv", hidden,
                            (w.T if tied else w).to(hidden.dtype))

    def _backbone(self, params, x, remat: bool = False, ctx=None):
        """Embeddings -> final norm: (hidden, the blocks' summed MoE aux
        loss). With ``remat`` each block keeps only its input for the
        backward pass and runs again there, as the JAX package's
        ``jax.checkpoint(policy=nothing_saveable)`` does."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for ltype, p in zip(self.layer_types, params["layers"]):
            if remat:
                x, a = checkpoint(self._block_apply, ltype, p, x, ctx,
                                  use_reentrant=False)
            else:
                x, a = self._block_apply(ltype, p, x, ctx)
            aux = aux + a
        final = params["final_norm"]
        if ctx is not None:
            final = local_tree(final, ctx.rank.device)
        return rmsnorm(final, x), aux

    def _ranks(self, mesh, batch: int) -> list:
        """The data-parallel ranks of ``batch`` rows over ``mesh``; one rank
        with every row for a MoE model with the global dispatch."""
        ranks = batch_ranks(mesh, batch)
        if (self.cfg.family == "moe" and len(ranks) > 1
                and not (self.cfg.moe_local_dispatch
                         and _local_dispatch(self.cfg, mesh))):
            return [Rank(0, mesh.devices[0], 0, batch, ranks[0].coords)]
        return ranks

    def _rank_rows(self, params, tokens, mesh, ranks):
        """Each rank's embedded rows on its device (the activation laid out
        as ``("batch", "seq", None)``)."""
        xs = [self._embed(params, tokens[r.lo:r.hi].to(r.device))
              for r in ranks]
        return logical_constraint(xs, ("batch", "seq", None), mesh)

    def forward(self, params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
        """tokens: [B, S] -> logits [B, S, V] in ``cfg.dtype`` (over a mesh
        on the mesh's first device)."""
        mesh = _mesh_of(mesh)
        if mesh is None:
            hidden, _ = self._backbone(params, self._embed(params, tokens))
            return self._logits(params, hidden)
        ranks = self._ranks(mesh, tokens.shape[0])
        out = []
        for r, x in zip(ranks, self._rank_rows(params, tokens, mesh, ranks)):
            hidden, _ = self._backbone(params, x, ctx=_Ctx(mesh, r))
            out.append(self._logits(params, hidden))
        out = logical_constraint(out, ("batch", "seq", "vocab"), mesh)
        return torch.cat([o.to(mesh.devices[0]) for o in out])

    def loss(self, params, batch: dict, mesh=None) -> tuple:
        """Next-token cross entropy (+ the MoE aux loss at ``moe_aux_coef /
        n_layers``). batch: tokens/labels [B, S]. Returns (loss, {"nll",
        "aux"}), 0-d float32 tensors.

        The embedding table is cast to ``cfg.dtype`` whole and then
        gathered, in the JAX package's order: the values equal
        ``_embed``'s, and in bf16 the table's gradient accumulates
        repeated tokens in bf16 as the reference's does.

        Over a mesh each data-parallel rank takes the mean over its rows
        (``rank_loss``); the ranks' means are weighted by their rows and
        summed in rank order, and the aux loss is the first rank's (the
        JAX package's ``moe_local`` returns one replicated value)."""
        cfg = self.cfg
        mesh = _mesh_of(mesh)
        if mesh is not None:
            ranks = self._ranks(mesh, batch["tokens"].shape[0])
            return combine_rank_losses(
                cfg, [self.rank_loss(params, batch, mesh, r) for r in ranks],
                ranks[0].device)
        x = self._embed(params, batch["tokens"], cast_table=True)
        hidden, aux = self._backbone(
            params, x, remat=cfg.remat and torch.is_grad_enabled())
        nll = token_nll(self._logits(params, hidden), batch["labels"])
        loss = nll
        if cfg.family == "moe":
            loss = loss + cfg.moe_aux_coef * aux / cfg.n_layers
        return loss, {"nll": nll, "aux": aux}

    def rank_loss(self, params, batch: dict, mesh, rank: Rank) -> tuple:
        """Data-parallel rank ``rank``'s part of ``loss`` over ``mesh``: its
        rows' mean nll weighted by its share of the batch, and its MoE aux
        loss; ``params`` the stored tree or the rank's own gathered copy."""
        cfg = self.cfg
        n = batch["tokens"].shape[0]
        x = self._embed(params, batch["tokens"][rank.lo:rank.hi].to(
            rank.device), cast_table=True)
        hidden, aux = self._backbone(
            params, x, remat=cfg.remat and torch.is_grad_enabled(),
            ctx=_Ctx(mesh, rank))
        nll = token_nll(self._logits(params, hidden),
                        batch["labels"][rank.lo:rank.hi].to(rank.device))
        return nll * ((rank.hi - rank.lo) / n), aux

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

    def _layer_cache_axes(self, ltype: str):
        kv_axes = KVCache(k=("batch", "kv_seq", "kv_heads", None),
                          v=("batch", "kv_seq", "kv_heads", None), length=())
        ssm_axes = ssm_lib.SSMCache(h=("batch", "heads", None, None),
                                    conv=("batch", None, "ssm_inner"))
        if ltype == "attn":
            return kv_axes
        if ltype == "hybrid":
            return {"attn": kv_axes, "ssm": ssm_axes}
        if ltype == "mlstm":
            return xlstm_lib.MLSTMCache(h=("batch", "heads", None, None))
        return xlstm_lib.SLSTMState(*((("batch", "heads", None),) * 4))

    def cache_axes(self) -> list:
        """The logical axes of ``init_cache``'s leaves, a layer at a time
        (the JAX package prepends ``"layers"`` on a stacked stack)."""
        return [self._layer_cache_axes(t) for t in self.layer_types]

    def cache_shardings(self, mesh, batch: int, max_seq: int,
                        dtype=torch.bfloat16) -> list:
        """A ``NamedSharding`` for each leaf of ``init_cache(batch,
        max_seq)``: the sequence of the attention caches over ``model``
        (flash-decode), their batch over the data axes."""
        shapes = self.init_cache(batch, max_seq, dtype, device="meta")
        return shardings_for_tree(shapes, self.cache_axes(), mesh)

    def _block_decode(self, ltype: str, p, x, cache, use_kernel=False,
                      ctx=None):
        """One block of a decode step. ``ctx``: the data-parallel rank over
        a mesh computing rows ``ctx.rank.lo``.. of the cache; its attention
        cache is the stored one (sharded, written by its owner rank) and
        its recurrent state the rank's rows."""
        cfg = self.cfg
        mesh, row0 = (None, 0) if ctx is None else (ctx.mesh, ctx.rank.lo)
        h = rmsnorm(p["ln1"], x)
        if ltype == "attn":
            mix, new_cache = attention_decode(p["attn"], cfg.attn_config(), h,
                                              cache, use_kernel=use_kernel,
                                              mesh=mesh, row0=row0)
        elif ltype == "hybrid":
            mix_a, kv = attention_decode(p["attn"], cfg.attn_config(), h,
                                         cache["attn"], use_kernel=use_kernel,
                                         mesh=mesh, row0=row0)
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
        x, _ = self._ffn(p, x + mix, ctx)
        return x, new_cache

    def decode_step(self, params, tokens: torch.Tensor, cache: list,
                    mesh=None, *, use_kernel: bool = False):
        """tokens: [B] -> (logits [B, V] float32, new cache). One decode
        position. Attention caches' K/V are updated in place; recurrent
        states are new tensors. ``use_kernel`` sends each attention layer to
        the GQA decode kernel (its plain version on the CPU); the JAX
        package's decode step always takes the einsum lane.

        Over a mesh the cache is the one ``cache_shardings`` lays out
        (``spec.place_tree``): each rank decodes its rows, writing K/V into
        the owning shard and attending shard by shard (the kernel lane
        launches the kernel once a shard a layer), its recurrent state
        gathered and laid out again; logits on the mesh's first device."""
        mesh = _mesh_of(mesh)
        if mesh is not None:
            return self._mesh_decode(params, tokens, cache, mesh, use_kernel)
        x = self._embed(params, tokens)[:, None]               # [B, 1, D]
        new_cache = []
        for ltype, p, c in zip(self.layer_types, params["layers"], cache):
            x, nc = self._block_decode(ltype, p, x, c, use_kernel)
            new_cache.append(nc)
        hidden = rmsnorm(params["final_norm"], x)
        return self._logits(params, hidden)[:, 0].to(torch.float32), new_cache

    def _mesh_decode(self, params, tokens, cache, mesh, use_kernel):
        ranks = self._ranks(mesh, tokens.shape[0])
        xs = self._rank_rows(params, tokens[:, None], mesh, ranks)
        states = [[] for _ in ranks]      # each rank's new recurrent states
        logits = []
        for j, (r, x) in enumerate(zip(ranks, xs)):
            ctx = _Ctx(mesh, r)
            for ltype, p, c in zip(self.layer_types, params["layers"],
                                   cache):
                x, nc = self._block_decode(
                    ltype, local_tree(p, r.device), x,
                    _rank_cache(c, r), use_kernel, ctx)
                states[j].append(nc)
            hidden = rmsnorm(local_tree(params["final_norm"], r.device), x)
            logits.append(self._logits(params, hidden)[:, 0])
        first = mesh.devices[0]
        new_cache = [_join_cache(c, [s[i] for s in states], first)
                     for i, c in enumerate(cache)]
        out = torch.cat([o.to(first) for o in logits])
        return out.to(torch.float32), new_cache

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

    def _prefill_block(self, ltype: str, p, x, s: int, ctx=None):
        """One block of the prompt: (x, the layer's decode cache)."""
        cfg = self.cfg
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
            mix, h_fin = xlstm_lib.mlstm_mix(p["mlstm"], cfg.xlstm_config(),
                                             h)
            cache = xlstm_lib.MLSTMCache(h=h_fin)
        else:  # slstm
            mix, cache = xlstm_lib.slstm(p["slstm"], cfg.xlstm_config(), h)
        x, _ = self._ffn(p, x + mix, ctx)
        return x, cache

    def prefill(self, params, tokens: torch.Tensor, mesh=None):
        """Run the full prompt, build decode caches, return last logits.

        Attention caches hold the last ``window`` (or all) positions in
        bf16, sized to the prompt, with ``length`` = S; the hybrid SSM cache
        holds the final state and the last ``conv_kernel - 1`` inputs (bf16),
        the mLSTM cache its final state and the sLSTM its final state. As in
        the JAX package, prefill attends through the einsum path (chunked
        when ``attn_chunk`` is set), never the flash kernel, and a decode
        step after an unwindowed prefill writes at slot S of an S-slot
        cache, which clamps onto the last entry (ROADMAP Queue C); over a
        mesh whose ``model`` axis shards that cache it writes nothing, as
        the JAX package's sharded write does.

        Over a mesh each rank runs its rows, and the caches are laid out
        per ``cache_shardings(mesh, B, S)``, ready for ``decode_step``."""
        mesh = _mesh_of(mesh)
        s = tokens.shape[1]
        if mesh is None:
            x = self._embed(params, tokens)
            caches = []
            for ltype, p in zip(self.layer_types, params["layers"]):
                x, cache = self._prefill_block(ltype, p, x, s)
                caches.append(cache)
            hidden = rmsnorm(params["final_norm"], x[:, -1:])
            return (self._logits(params, hidden)[:, 0].to(torch.float32),
                    caches)
        ranks = self._ranks(mesh, tokens.shape[0])
        first = mesh.devices[0]
        logits, rank_caches = [], []
        for r, x in zip(ranks, self._rank_rows(params, tokens, mesh, ranks)):
            caches = []
            for ltype, p in zip(self.layer_types, params["layers"]):
                x, cache = self._prefill_block(
                    ltype, local_tree(p, r.device), x, s, _Ctx(mesh, r))
                caches.append(cache)
            hidden = rmsnorm(local_tree(params["final_norm"], r.device),
                             x[:, -1:])
            logits.append(self._logits(params, hidden)[:, 0])
            rank_caches.append(caches)
        caches = map_leaves(
            lambda *parts: _cat_rows(parts, first), rank_caches[0],
            *rank_caches[1:])
        caches = place_tree(caches, shardings_for_tree(
            caches, self.cache_axes(), mesh))
        out = torch.cat([o.to(first) for o in logits])
        return out.to(torch.float32), caches


def combine_rank_losses(cfg, parts: list, device) -> tuple:
    """(loss, {"nll", "aux"}) of the data-parallel ranks' (nll part, aux)
    pairs: the parts summed in rank order, the first rank's aux."""
    nll = None
    for part, _ in parts:
        nll = part.to(device) if nll is None else nll + part.to(device)
    aux = parts[0][1].to(device)
    loss = nll
    if cfg.family == "moe":
        loss = loss + cfg.moe_aux_coef * aux / cfg.n_layers
    return loss, {"nll": nll, "aux": aux}


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood: logits [B, S, V] taken to
    float32, ``log_softmax``, the label's entry."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


@dataclasses.dataclass(frozen=True)
class _Ctx:
    """A data-parallel rank of a mesh computing its rows (a plain object,
    so that ``torch.utils.checkpoint``'s pytree walk of a block's
    arguments takes it whole)."""
    mesh: Mesh
    rank: Rank


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a device.Mesh, got "
                        f"{type(mesh).__name__}")


def _mesh_of(mesh):
    """The mesh to shard over: None without one or for a mesh of one device
    (the unsharded path, which such a mesh is in the JAX package too)."""
    if mesh is None:
        return None
    _check_mesh(mesh)
    return mesh if mesh.size > 1 else None


def _local_dispatch(cfg, mesh) -> bool:
    """Whether ``moe_local`` shards over ``mesh`` (else it falls back to the
    global dispatch, as the JAX package's does)."""
    n = mesh.axis_size("model")
    return n > 1 and cfg.n_experts % n == 0


def _rows(x, rank: Rank):
    """Rows [lo, hi) of a cache leaf on the rank's device (a 0-d leaf
    whole)."""
    if x.ndim == 0:
        return gather(x, rank.device)
    if isinstance(x, Sharded):
        return x.gather(rank.device, rows=(rank.lo, rank.hi))
    return x[rank.lo:rank.hi].to(rank.device)


def _rank_cache(cache, rank: Rank):
    """A layer's cache as rank ``rank`` decodes it: attention K/V as they
    are stored (``attention_decode`` writes and reads their shards), the
    position on the rank's device, recurrent states the rank's rows."""
    if isinstance(cache, KVCache):
        return cache._replace(length=gather(cache.length, rank.device))
    if isinstance(cache, dict):
        return {k: _rank_cache(v, rank) for k, v in cache.items()}
    return map_leaves(lambda x: _rows(x, rank), cache)


def _cat_rows(parts, device):
    """The ranks' rows of a leaf joined on ``device`` (a 0-d leaf is the
    first rank's)."""
    if parts[0].ndim == 0:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


def _join_cache(old, parts: list, device):
    """A layer's new cache from the ranks' ``parts``, laid out as ``old``:
    the attention K/V are ``old``'s (written in place), lengths and
    recurrent states joined by rows and placed as before."""
    if isinstance(old, KVCache):
        return old._replace(length=_place_like(
            parts[0].length.to(device), old.length))
    if isinstance(old, dict):
        return {k: _join_cache(old[k], [p[k] for p in parts], device)
                for k in old}
    return map_leaves(lambda o, *ps: _place_like(_cat_rows(ps, device), o),
                      old, *parts)


def _place_like(x, like):
    return put(x, like.sharding) if isinstance(like, Sharded) else x
