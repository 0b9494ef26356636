"""Shared transformer layers: norms, RoPE, GQA attention, MLP.

Plain functions over ``Params`` modules built from ``spec.P`` descriptors,
with the JAX package's names, argument orders and layouts (activations
[B, S, D], heads [B, S, H, Dh]). All attention paths support GQA
(n_kv_heads <= n_heads), optional qk-norm, optional sliding windows, causal
or bidirectional masks, and a KV-cache decode mode. Full-sequence attention
goes to the flash kernel when asked (``kernels.flash_attention``), single-
token decode to the GQA decode kernel (``kernels.decode_gqa``); otherwise
both run the einsum path.

Types follow JAX's rules. A JAX einsum with ``preferred_element_type=f32``
on bf16 operands gives a float32 result, so those einsums run on float32
copies of their operands (bf16 products are exact in float32); where JAX
promotes bf16 against float32 (a bf16 query against the server's float32
cache), the same float32 einsum is what it computes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .spec import P

F32 = torch.float32
NEG_INF = -1e30
_ROADMAP_MESH = "ROADMAP.md, Queue A, item 5 (telemetry, mesh and fleet)"

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int) -> dict:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * params["scale"].to(F32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, Dh]; positions: [B, S] or [S].

    ``freqs`` is float32 ``theta ** (-arange / half)``, as in the JAX
    package; the two libraries' float32 ``pow`` may differ by an ulp, which a
    large position multiplies (ROADMAP Queue C)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    angles = positions[..., None].to(F32) * freqs   # [B?, S, half]
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class AttnConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    causal: bool = True
    window: int = 0          # 0 = full attention; >0 = sliding window
    rope_theta: float = 1e4
    use_rope: bool = True
    chunk: int = 0           # >0: chunked attention, O(S*chunk) logits


def attention_params(cfg: AttnConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": P((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": P((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = {"scale": P((dh,), (None,), init="ones")}
        p["k_norm"] = {"scale": P((dh,), (None,), init="ones")}
    return p


def _qkv(params, cfg: AttnConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _masked_softmax_attention(qg, k, v, mask, out_dtype):
    """The einsum core of ``_sdpa``: qg [B, Sq, KVH, G, Dh], k/v
    [B, Sk, KVH, Dh], mask [Sq, Sk] -> [B, Sq, H, Dh] in ``out_dtype``."""
    b, sq, kvh, g, dh = qg.shape
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(F32),
                          k.to(F32)) / math.sqrt(dh)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype).to(F32),
                       v.to(F32))
    return out.reshape(b, sq, kvh * g, dh).to(out_dtype)


def _mask(qpos, kpos, cfg: AttnConfig):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if cfg.causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if cfg.window > 0:
        mask &= kpos[None, :] > qpos[:, None] - cfg.window
    return mask


def _sdpa(q, k, v, cfg: AttnConfig, q_offset=0):
    """Reference scaled-dot-product attention with GQA + masks.

    q: [B, Sq, H, Dh]; k/v: [B, Sk, KVH, Dh]. q_offset: absolute position of
    q[0]. Returns [B, Sq, H, Dh] in q's dtype; float32 logits and sums."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    return _masked_softmax_attention(qg, k, v, _mask(qpos, kpos, cfg),
                                     q.dtype)


def _sdpa_chunked(q, k, v, cfg: AttnConfig):
    """Attention one block of ``cfg.chunk`` queries at a time against the
    full K: logits memory O(chunk * Sk) instead of O(Sq * Sk). Falls back to
    ``_sdpa`` when the chunk does not divide Sq, as the JAX package does."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    c = min(cfg.chunk, sq)
    if sq % c != 0:
        return _sdpa(q, k, v, cfg)
    kpos = torch.arange(sk, device=q.device)
    blocks = []
    for qi in range(sq // c):
        qblk = q[:, qi * c:(qi + 1) * c].reshape(b, c, kvh, h // kvh, dh)
        qpos = qi * c + torch.arange(c, device=q.device)
        blocks.append(_masked_softmax_attention(
            qblk, k, v, _mask(qpos, kpos, cfg), q.dtype))
    return torch.cat(blocks, dim=1)


def attention(params, cfg: AttnConfig, x, positions=None, *,
              kv: Optional[tuple] = None, use_kernel: bool = False):
    """Full-sequence attention (prefill). x: [B, S, D].

    kv: optional external (k, v) for cross-attention. ``use_kernel`` sends
    self-attention to the flash kernel (its plain version on the CPU)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _qkv(params, cfg, x, positions)
    if kv is not None:
        k, v = kv
    if use_kernel and kv is None:
        from ..kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                     window=cfg.window)
    elif cfg.chunk > 0:
        out = _sdpa_chunked(q, k, v, cfg)
    else:
        out = _sdpa(q, k, v, cfg)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_max, KVH, Dh]
    v: torch.Tensor
    length: torch.Tensor  # 0-d int32: tokens cached so far


def init_kv_cache(batch: int, max_seq: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    """An empty cache on ``device`` (the card unless the caller asks for the
    CPU; raises without CUDA, as every entry point does)."""
    device = resolve_device(device)
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def _cache_update(cache_arr, new, slot, mesh=None):
    """Write one token's K/V [B, 1, KVH, Dh] at ``slot`` (a 0-d tensor) of
    cache_arr [B, S, KVH, Dh], IN PLACE, and return cache_arr.

    The slot is clamped to [0, S - 1], as XLA's ``dynamic_update_slice``
    clamps its start index: a write at S overwrites the last entry, as the
    JAX package does (ROADMAP Queue C). The write is an ``index_copy_`` with
    the slot on the device, so no step waits for the host."""
    if mesh is not None:
        raise NotImplementedError(
            f"a sharded KV cache is not ported yet: {_ROADMAP_MESH}")
    slot = slot.to(torch.long).clamp(0, cache_arr.shape[1] - 1).reshape(1)
    return cache_arr.index_copy_(1, slot, new.to(cache_arr.dtype))


def attention_decode(params, cfg: AttnConfig, x, cache: KVCache, *,
                     use_kernel: bool = False, mesh=None):
    """Single-token decode. x: [B, 1, D]; returns (out [B, 1, D], cache).

    With a sliding window the cache is a rolling buffer of size window. The
    new token's K/V are written into ``cache.k`` / ``cache.v`` in place (the
    returned cache shares them; clone the cache first to keep the old one).
    ``use_kernel`` sends the attention to the GQA decode kernel (its plain
    version on the CPU)."""
    b = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _qkv(params, cfg, x, pos.expand(b, 1))
    size = cache.k.shape[1]
    slot = pos % size if cfg.window > 0 else pos
    k = _cache_update(cache.k, k_new, slot, mesh)
    v = _cache_update(cache.v, v_new, slot, mesh)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    groups = cfg.n_heads // kvh
    if use_kernel:
        from ..kernels.decode_gqa import ops as dg_ops
        valid_len = torch.clamp(pos + 1, max=size)
        out = dg_ops.decode_gqa(q[:, 0], k, v, valid_len)
    else:
        qg = q.reshape(b, kvh, groups, dh)
        logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(F32),
                              k.to(F32)) / math.sqrt(dh)
        kpos = torch.arange(size, device=x.device)
        valid = kpos <= pos if cfg.window == 0 else (
            (kpos <= pos) | (pos >= size))
        logits = torch.where(valid, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v.dtype).to(F32),
                           v.to(F32))
    out = out.reshape(b, 1, cfg.n_heads, dh).to(x.dtype)
    proj = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return proj, KVCache(k=k, v=v, length=pos + 1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_params(d: int, f: int, gated: bool = True) -> dict:
    p = {
        "w_in": P((d, f), ("embed", "mlp")),
        "w_out": P((f, d), ("mlp", "embed")),
    }
    if gated:
        p["w_gate"] = P((d, f), ("embed", "mlp"))
    return p


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP, or (no ``w_gate``) GELU in its tanh form, which is
    ``jax.nn.gelu``'s default."""
    h = torch.einsum("bsd,df->bsf", x, params["w_in"].to(x.dtype))
    if "w_gate" in params:
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(x.dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, params["w_out"].to(x.dtype))
