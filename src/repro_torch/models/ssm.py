"""Selective state-space layer (Mamba-2 / SSD style), chunked scan.

The recurrence per head (state matrix h: [N, Dh]):

    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)        a_t = exp(-softplus(A) dt_t)
    y_t = C_t · h_t + D * x_t

is evaluated in chunks of length Q, as the JAX package's ``models/ssm.py``
does: inside a chunk a masked decay matrix turns the scan into two float32
einsums, and a Python loop over the chunks carries the float32
[B, H, N, Dh] state (the reference's ``lax.scan``). The reference's scan is
jnp and ``lax.scan``, not a Pallas kernel, so it stays plain PyTorch here.
Decode is the O(1) recurrence step.

Used by hymba's parallel attention + SSM heads and, as chunked gated linear
attention, by the xLSTM mLSTM block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .spec import P

F32 = torch.float32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


class SSMConfig(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    state: int          # N
    conv_kernel: int = 4
    chunk: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def ssm_params(cfg: SSMConfig) -> dict:
    d, i, h, n = cfg.d_model, cfg.d_inner, cfg.n_heads, cfg.state
    return {
        "w_in": P((d, 2 * i), ("embed", "ssm_inner")),       # x and gate z
        "conv": P((cfg.conv_kernel, i), ("conv", "ssm_inner"), scale=0.5),
        "w_dt": P((d, h), ("embed", "heads"), scale=0.1),
        "dt_bias": P((h,), ("heads",), init="zeros"),
        "w_bc": P((d, 2 * h * n), ("embed", "heads"), scale=0.5),
        "a_log": P((h,), ("heads",), init="zeros"),
        "d_skip": P((h,), ("heads",), init="ones"),
        "w_out": P((i, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 carry: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x: [B, S, I], w: [K, I].

    carry: [B, K-1, I] previous inputs for decode; returns (y, new_carry)."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i][None, None, :]
    new_carry = xp[:, -(k - 1):] if k > 1 else carry
    return F.silu(y), new_carry


def _gates(params, cfg: SSMConfig, xr: torch.Tensor):
    """Common projections. xr: [B, S, D] -> (a, dt, B, C) with a, dt:
    [B, S, H] (a float32); B, C: [B, S, H, N]."""
    b, s, _ = xr.shape
    h, n = cfg.n_heads, cfg.state
    dt = softplus(
        torch.einsum("bsd,dh->bsh", xr, params["w_dt"].to(xr.dtype))
        + params["dt_bias"].to(xr.dtype))
    bc = torch.einsum("bsd,de->bse", xr, params["w_bc"].to(xr.dtype))
    bmat, cmat = torch.split(bc.reshape(b, s, h, 2 * n), n, dim=-1)
    a = torch.exp(-softplus(params["a_log"].to(F32)) * dt.to(F32))
    return a, dt, bmat, cmat


def ssd_scan(a, dt, bmat, cmat, values, chunk: int, h0=None):
    """Chunked linear recurrence.

    a, dt: [B, S, H]; bmat / cmat: [B, S, H, N]; values: [B, S, H, Dh].
    Returns (y: [B, S, H, Dh] in values' dtype, h_final: [B, H, N, Dh]
    float32)."""
    b, s, h, n = bmat.shape
    dh = values.shape[-1]
    q = min(chunk, s)
    if s % q != 0:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    hc = (torch.zeros((b, h, n, dh), dtype=F32, device=values.device)
          if h0 is None else h0)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=values.device))[None, :, :, None]
    ys = []
    for c0 in range(0, s, q):
        sl = slice(c0, c0 + q)
        ac, dtc = a[:, sl].to(F32), dt[:, sl].to(F32)          # [B, Q, H]
        bb, cc = bmat[:, sl].to(F32), cmat[:, sl].to(F32)      # [B, Q, H, N]
        vv = values[:, sl].to(F32)                              # [B, Q, H, Dh]
        la = torch.log(torch.clamp(ac, min=1e-37))
        cum = torch.cumsum(la, dim=1)                           # inclusive
        # intra-chunk: G[i, j] = (C_i . B_j) exp(cum_i - cum_j), j <= i
        decay = torch.exp(cum[:, :, None] - cum[:, None, :, :])  # [B,Q,Q,H]
        decay = torch.where(mask, decay, 0.0)
        g = torch.einsum("bihn,bjhn->bijh", cc, bb) * decay
        g = g * dtc[:, None]
        y_intra = torch.einsum("bijh,bjhd->bihd", g, vv)
        # inter-chunk: C_i . (exp(cum_i) h_start)
        y_inter = torch.einsum("bihn,bhnd->bihd",
                               cc * torch.exp(cum)[..., None], hc)
        # state update
        w = torch.exp(cum[:, -1:, :] - cum) * dtc                # [B, Q, H]
        hc = (torch.exp(cum[:, -1])[:, :, None, None] * hc
              + torch.einsum("bqh,bqhn,bqhd->bhnd", w, bb, vv))
        ys.append((y_intra + y_inter).to(values.dtype))
    return torch.cat(ys, dim=1), hc


class SSMCache(NamedTuple):
    h: torch.Tensor      # [B, H, N, Dh] float32
    conv: torch.Tensor   # [B, K-1, I]


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype=torch.bfloat16,
                   device="cuda") -> SSMCache:
    device = resolve_device(device)
    return SSMCache(
        h=torch.zeros((batch, cfg.n_heads, cfg.state, cfg.head_dim),
                      dtype=F32, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                         dtype=dtype, device=device))


def ssm_mix(params, cfg: SSMConfig, x: torch.Tensor):
    """The full-sequence SSM branch. x: [B, S, D] -> (out [B, S, D], the
    final state [B, H, N, Dh], the pre-conv inputs [B, S, I])."""
    b, s, _ = x.shape
    xi = torch.einsum("bsd,de->bse", x, params["w_in"].to(x.dtype))
    xin, z = torch.chunk(xi, 2, dim=-1)
    xc, _ = _causal_conv(xin, params["conv"].to(x.dtype))
    a, dt, bmat, cmat = _gates(params, cfg, x)
    vals = xc.reshape(b, s, cfg.n_heads, cfg.head_dim)
    y, h_fin = ssd_scan(a, dt, bmat, cmat, vals, cfg.chunk)
    y = y + params["d_skip"].to(x.dtype)[None, None, :, None] * vals
    y = y.reshape(b, s, cfg.d_inner) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["w_out"].to(x.dtype))
    return out, h_fin, xin


def ssm(params, cfg: SSMConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward. x: [B, S, D] -> [B, S, D]."""
    return ssm_mix(params, cfg, x)[0]


def ssm_decode(params, cfg: SSMConfig, x: torch.Tensor, cache: SSMCache):
    """Single-token decode. x: [B, 1, D] -> ([B, 1, D], new cache)."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.head_dim
    xi = torch.einsum("bsd,de->bse", x, params["w_in"].to(x.dtype))
    xin, z = torch.chunk(xi, 2, dim=-1)
    # the carry and the new inputs concatenate in their promoted dtype, as
    # jnp.concatenate promotes (a float32 cache against bf16 activations)
    xc, conv_new = _causal_conv(xin, params["conv"].to(x.dtype), cache.conv)
    a, dt, bmat, cmat = _gates(params, cfg, x)
    v = xc.reshape(b, 1, h, dh)[:, 0].to(F32)                   # [B, H, Dh]
    u = dt[:, 0].to(F32)[..., None, None] * (
        bmat[:, 0].to(F32)[..., None] * v[:, :, None, :])       # [B,H,N,Dh]
    h_new = a[:, 0][..., None, None] * cache.h + u
    y = torch.einsum("bhn,bhnd->bhd", cmat[:, 0].to(F32), h_new)
    y = y + params["d_skip"].to(F32)[None, :, None] * v
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype) * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["w_out"].to(x.dtype))
    return out, SSMCache(h=h_new, conv=conv_new)
