"""Shared transformer layers: norms, RoPE, GQA attention, MLP.

Plain functions over ``Params`` modules built from ``spec.P`` descriptors,
with the JAX package's names, argument orders and layouts (activations
[B, S, D], heads [B, S, H, Dh]). All attention paths support GQA
(n_kv_heads <= n_heads), optional qk-norm, optional sliding windows, causal
or bidirectional masks, and a KV-cache decode mode. Full-sequence attention
goes to the flash kernel when asked (``kernels.flash_attention``), single-
token decode to the GQA decode kernel (``kernels.decode_gqa``); otherwise
both run the einsum path.

Over a device mesh (``attention_decode(mesh=)``) a KV cache whose sequence
dim is sharded over ``model`` (a ``spec.Sharded`` placed per
``DecoderLM.cache_shardings``) is written only in the owning rank's shard
(``_cache_update``) and read shard by shard, each on its own device
(flash-decode: the einsum lane takes the softmax's max and sum over the
shards before it normalises, the kernel lane combines the shards' partial
softmaxes), in rank order: no decode step gathers a whole cache onto one
device.

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
from .spec import P, Sharded

F32 = torch.float32
NEG_INF = -1e30

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


def _owner_write(block, new, slot, s0: int) -> None:
    """The owner-rank write of the JAX package's sharded cache update on one
    block holding sequence positions [s0, s0 + S_loc): the local slot
    clamped into the block, the old entry kept unless the slot falls in
    it, so that a slot outside every block writes nothing."""
    s_loc = block.shape[1]
    ls = slot.to(device=block.device, dtype=torch.long) - s0
    inb = (ls >= 0) & (ls < s_loc)
    ls_c = ls.clamp(0, s_loc - 1).reshape(1)
    old = block.index_select(1, ls_c)
    block.index_copy_(1, ls_c, torch.where(inb, new.to(block.dtype), old))


def _seq_sharded(mesh, size: int) -> bool:
    """The JAX package's condition for the owner-rank write: a ``model``
    axis of more than one device that divides the cache's length."""
    n = mesh.axis_size("model") if mesh is not None else 1
    return n > 1 and size % n == 0


def _cache_update(cache_arr, new, slot, mesh=None, row0: int = 0):
    """Write one token's K/V [B, 1, KVH, Dh] at ``slot`` (a 0-d tensor) of
    cache_arr [B, S, KVH, Dh], IN PLACE, and return cache_arr.

    Without a usable mesh the slot is clamped to [0, S - 1], as XLA's
    ``dynamic_update_slice`` clamps its start index: a write at S overwrites
    the last entry, as the JAX package does (ROADMAP Queue C). The write is
    an ``index_copy_`` with the slot on the device, so no step waits for
    the host.

    With the sequence dim sharded over ``model`` (the JAX package's
    ``shard_map`` lane: a ``model`` axis over 1 that divides S) only the
    rank that owns the slot writes, into its own shard, and a slot at or
    past S writes nothing, as the JAX package's sharded write does. A
    ``Sharded`` cache is written block by block on each block's device
    (every copy of a shard alike); ``new`` then holds the cache's rows
    ``[row0, row0 + B)``. A plain tensor with such a mesh gets the same
    owner-rank semantics in one piece."""
    if isinstance(cache_arr, Sharded):
        size = cache_arr.shape[1]
        for i, block in enumerate(cache_arr.blocks):
            (r0, r1), (s0, s1) = cache_arr.ranges(i)[:2]
            lo, hi = max(r0, row0), min(r1, row0 + new.shape[0])
            if lo >= hi:
                continue
            part = new[lo - row0:hi - row0].to(block.device)
            rows = block[lo - r0:hi - r0]
            if s1 - s0 < size:
                _owner_write(rows, part, slot, s0)
            else:
                ls = slot.to(device=block.device, dtype=torch.long)
                rows.index_copy_(1, ls.clamp(0, size - 1).reshape(1),
                                 part.to(block.dtype))
        return cache_arr
    rows = (cache_arr if row0 == 0 and new.shape[0] == cache_arr.shape[0]
            else cache_arr[row0:row0 + new.shape[0]])
    if _seq_sharded(mesh, cache_arr.shape[1]):
        _owner_write(rows, new, slot, 0)
        return cache_arr
    slot = slot.to(torch.long).clamp(0, cache_arr.shape[1] - 1).reshape(1)
    rows.index_copy_(1, slot, new.to(cache_arr.dtype))
    return cache_arr


def _seq_shards(cache_arr: Sharded, lo: int, hi: int) -> list:
    """(s0, s1, pieces) of each sequence shard of a ``Sharded`` cache, in
    rank order: ``pieces`` the (block index, r0) of the blocks, first in
    mesh order, that hold rows [lo, hi) of the shard, in row order (one
    block when the rows are a data-parallel rank's)."""
    shards: dict = {}
    for i in cache_arr.unique():
        (r0, r1), (s0, s1) = cache_arr.ranges(i)[:2]
        if r0 < hi and lo < r1:
            shards.setdefault((s0, s1), []).append((i, r0))
    return [(s0, s1, sorted(pieces, key=lambda p: p[1]))
            for (s0, s1), pieces in sorted(shards.items())]


def _shard_rows(x: Sharded, pieces: list, lo: int, hi: int):
    """Rows [lo, hi) of one sequence shard, on its first piece's device:
    the block's own rows (a view) when one block holds them."""
    parts = []
    for i, r0 in pieces:
        blk = x.blocks[i]
        parts.append(blk[max(lo - r0, 0):min(hi - r0, blk.shape[0])])
    if len(parts) == 1:
        return parts[0]
    return torch.cat([t.to(parts[0].device) for t in parts])


def _sharded_decode(q, cfg: AttnConfig, cache: KVCache, pos, row0: int,
                    use_kernel: bool):
    """Attention of one query a row over a ``Sharded`` cache's sequence
    shards, each on its own device, combined on q's device in rank order:
    [B, H, Dh] float32.

    The einsum lane computes the unsharded lane's softmax in two passes
    over the shards: each shard's masked logits and max m_r (m = max m_r),
    then its sum l_r = sum e^(logit - m) (l = the l_r summed in rank
    order), then its normalised p = e^(logit - m) / l rounded to the
    cache's dtype before P.V, as the unsharded lane and the JAX package's
    ``attention_decode`` (GSPMD's global softmax over a sharded cache)
    round it; the shards' P.V are summed in rank order. The kernel lane
    launches the decode kernel on each shard with its local valid length
    and its log-sum-exp (p kept in float32, as the TPU kernel keeps it),
    and combines the shards' outputs weighted by e^(lse_r - max lse). A
    shard with no valid key has weight 0."""
    b = q.shape[0]
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    groups = cfg.n_heads // kvh
    size = cache.k.shape[1]
    home = q.device
    parts = []
    for s0, s1, pieces in _seq_shards(cache.k, row0, row0 + b):
        kb = _shard_rows(cache.k, pieces, row0, row0 + b)
        vb = _shard_rows(cache.v, pieces, row0, row0 + b)
        dev = kb.device
        qd, pd = q.to(dev), pos.to(dev)
        if use_kernel:
            from ..kernels.decode_gqa import ops as dg_ops
            valid_len = torch.clamp(pd + 1, max=size)
            local = torch.clamp(valid_len - s0, 0, s1 - s0)
            out_r, lse_r = dg_ops.decode_gqa(qd[:, 0], kb, vb, local,
                                             return_lse=True)
            parts.append((out_r.to(home), lse_r.to(home)))
            continue
        qg = qd.reshape(b, kvh, groups, dh)
        logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(F32),
                              kb.to(F32)) / math.sqrt(dh)
        kpos = torch.arange(s0, s1, device=dev)
        valid = kpos <= pd if cfg.window == 0 else (
            (kpos <= pd) | (pd >= size))
        logits = torch.where(valid, logits, NEG_INF)
        parts.append((logits, vb, logits.amax(-1, keepdim=True).to(home)))
    if use_kernel:
        m = torch.stack([lse for _, lse in parts]).amax(0)
        m = torch.where(torch.isfinite(m), m, 0.0)
        out = l = None
        for out_r, lse_r in parts:
            w = torch.exp(lse_r - m)[..., None]
            out = out_r * w if out is None else out + out_r * w
            l = w if l is None else l + w
        return out / l.clamp_min(1e-30)
    m = torch.stack([m_r for _, _, m_r in parts]).amax(0)
    l = None
    for logits, _, _ in parts:
        l_r = torch.exp(logits - m.to(logits.device)).sum(
            -1, keepdim=True).to(home)
        l = l_r if l is None else l + l_r
    out = None
    for logits, vb, _ in parts:
        dev = logits.device
        p = torch.exp(logits - m.to(dev)) / l.to(dev)
        acc_r = torch.einsum("bhgk,bkhd->bhgd", p.to(vb.dtype).to(F32),
                             vb.to(F32)).to(home)
        out = acc_r if out is None else out + acc_r
    return out.reshape(b, cfg.n_heads, dh)


def attention_decode(params, cfg: AttnConfig, x, cache: KVCache, *,
                     use_kernel: bool = False, mesh=None, row0: int = 0):
    """Single-token decode. x: [B, 1, D]; returns (out [B, 1, D], cache).

    With a sliding window the cache is a rolling buffer of size window. The
    new token's K/V are written into ``cache.k`` / ``cache.v`` in place (the
    returned cache shares them; clone the cache first to keep the old one).
    ``use_kernel`` sends the attention to the GQA decode kernel (its plain
    version on the CPU).

    ``mesh``: with ``cache.k`` / ``cache.v`` ``Sharded`` (x then holds the
    cache's rows ``[row0, row0 + B)``, a data-parallel rank's), the write
    goes to the owning shard and each sequence shard is attended on its own
    device (``_sharded_decode``); with plain tensors the write follows the
    JAX package's rule for the mesh (``_cache_update``)."""
    b = x.shape[0]
    pos = cache.length
    q, k_new, v_new = _qkv(params, cfg, x, pos.expand(b, 1))
    size = cache.k.shape[1]
    slot = pos % size if cfg.window > 0 else pos
    k = _cache_update(cache.k, k_new, slot, mesh, row0)
    v = _cache_update(cache.v, v_new, slot, mesh, row0)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    groups = cfg.n_heads // kvh
    if isinstance(k, Sharded):
        out = _sharded_decode(q, cfg, KVCache(k, v, pos), pos, row0,
                              use_kernel)
        return _decode_out(params, cfg, x, out), KVCache(k=k, v=v,
                                                         length=pos + 1)
    kr, vr = ((k, v) if row0 == 0 and b == k.shape[0]
              else (k[row0:row0 + b], v[row0:row0 + b]))
    if use_kernel:
        from ..kernels.decode_gqa import ops as dg_ops
        valid_len = torch.clamp(pos + 1, max=size)
        out = dg_ops.decode_gqa(q[:, 0], kr, vr, valid_len)
    else:
        qg = q.reshape(b, kvh, groups, dh)
        logits = torch.einsum("bhgd,bkhd->bhgk", qg.to(F32),
                              kr.to(F32)) / math.sqrt(dh)
        kpos = torch.arange(size, device=x.device)
        valid = kpos <= pos if cfg.window == 0 else (
            (kpos <= pos) | (pos >= size))
        logits = torch.where(valid, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v.dtype).to(F32),
                           vr.to(F32))
    return _decode_out(params, cfg, x, out), KVCache(k=k, v=v,
                                                     length=pos + 1)


def _decode_out(params, cfg: AttnConfig, x, out):
    """The heads' outputs [B, H, Dh] (float32) projected back: [B, 1, D]."""
    out = out.reshape(x.shape[0], 1, cfg.n_heads, cfg.head_dim).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


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
