"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, recurrent), as the JAX package's ``models/xlstm.py`` writes them:

* mLSTM is gated linear attention on the SSD chunk scan of ``models.ssm``
  (state: a k⊗v matrix per head plus a normaliser column of ones), with a
  softplus input gate.
* sLSTM keeps the stabilised exponential gating (a running max m of the log
  gates, starting at m = -10 and n = 1e-6) and per-head recurrent matrices;
  it is a loop over time, as the reference's ``lax.scan`` is.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import rmsnorm
from .spec import P
from .ssm import softplus, ssd_scan

F32 = torch.float32


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int
    chunk: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_params(cfg: XLSTMConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "w_q": P((d, d), ("embed", "heads")),
        "w_k": P((d, d), ("embed", "heads")),
        "w_v": P((d, d), ("embed", "heads")),
        "w_if": P((d, 2 * h), ("embed", "heads"), scale=0.1),
        "if_bias": P((2 * h,), ("heads",), init="zeros"),
        "w_z": P((d, d), ("embed", "heads")),
        "head_norm": {"scale": P((cfg.head_dim,), (None,), init="ones")},
        "w_out": P((d, d), ("heads", "embed")),
    }


def _mlstm_gates(params, cfg: XLSTMConfig, x: torch.Tensor):
    """x: [B, S, D] -> (q, k, v [B, S, H, Dh], input gate [B, S, H] in x's
    dtype, forget gate [B, S, H] float32)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim

    def proj(name):
        return torch.einsum("bsd,de->bse", x, params[name].to(x.dtype)
                            ).reshape(b, s, h, dh)

    q, k, v = proj("w_q"), proj("w_k"), proj("w_v")
    k = k / torch.sqrt(torch.tensor(dh, dtype=x.dtype, device=x.device))
    gif = (torch.einsum("bsd,de->bse", x, params["w_if"].to(x.dtype))
           + params["if_bias"].to(x.dtype)).reshape(b, s, 2, h)
    i_gate = softplus(gif[:, :, 0])                       # >= 0
    f_gate = torch.sigmoid(gif[:, :, 1].to(F32))          # decay in (0, 1)
    return q, k, v, i_gate, f_gate


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v with the normaliser's column of ones appended: [..., Dh + 1]."""
    return torch.cat([v, torch.ones((*v.shape[:-1], 1), dtype=v.dtype,
                                    device=v.device)], dim=-1)


def _mlstm_norm_out(params, cfg: XLSTMConfig, y_ext, z, x_dtype):
    """Split (values, normaliser), normalise, head-norm, gate, project."""
    y, norm = y_ext[..., :-1], y_ext[..., -1:]
    y = y / torch.clamp(torch.abs(norm), min=1.0)
    y = rmsnorm(params["head_norm"], y)
    b, s = y.shape[:2]
    y = y.reshape(b, s, cfg.d_model).to(x_dtype) * F.silu(z)
    return torch.einsum("bse,ed->bsd", y, params["w_out"].to(x_dtype))


def mlstm_mix(params, cfg: XLSTMConfig, x: torch.Tensor):
    """Full-sequence mLSTM: (out [B, S, D], final state [B, H, Dh, Dh+1])."""
    q, k, v, i_gate, f_gate = _mlstm_gates(params, cfg, x)
    y_ext, h_fin = ssd_scan(f_gate, i_gate, k, q, _with_ones(v), cfg.chunk)
    z = torch.einsum("bsd,de->bse", x, params["w_z"].to(x.dtype))
    return _mlstm_norm_out(params, cfg, y_ext, z, x.dtype), h_fin


def mlstm(params, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    return mlstm_mix(params, cfg, x)[0]


class MLSTMCache(NamedTuple):
    h: torch.Tensor   # [B, H, Dh, Dh+1] float32 (matrix memory + normaliser)


def init_mlstm_cache(batch: int, cfg: XLSTMConfig,
                     device="cuda") -> MLSTMCache:
    return MLSTMCache(h=torch.zeros(
        (batch, cfg.n_heads, cfg.head_dim, cfg.head_dim + 1), dtype=F32,
        device=resolve_device(device)))


def mlstm_decode(params, cfg: XLSTMConfig, x: torch.Tensor,
                 cache: MLSTMCache):
    q, k, v, i_gate, f_gate = _mlstm_gates(params, cfg, x)
    v_ext = _with_ones(v)
    u = i_gate[:, 0, :, None, None].to(F32) * (
        k[:, 0].to(F32)[..., None] * v_ext[:, 0].to(F32)[:, :, None, :])
    h_new = f_gate[:, 0, :, None, None] * cache.h + u
    y_ext = torch.einsum("bhn,bhnd->bhd", q[:, 0].to(F32), h_new)
    z = torch.einsum("bsd,de->bse", x, params["w_z"].to(x.dtype))
    out = _mlstm_norm_out(params, cfg, y_ext[:, None], z, x.dtype)
    return out, MLSTMCache(h=h_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_params(cfg: XLSTMConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "w_gates": P((d, 4 * d), ("embed", "heads")),        # z, i, f, o
        "r_gates": P((h, dh, 4 * dh), ("heads", None, None), scale=0.5),
        "b_gates": P((4 * d,), ("heads",), init="zeros"),
        "head_norm": {"scale": P((dh,), (None,), init="ones")},
        "w_out": P((d, d), ("heads", "embed")),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, Dh]
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor   # stabiliser (running max of the log gates)


def init_slstm_state(batch: int, cfg: XLSTMConfig,
                     device="cuda") -> SLSTMState:
    z = torch.zeros((batch, cfg.n_heads, cfg.head_dim), dtype=F32,
                    device=resolve_device(device))
    return SLSTMState(c=z, n=z + 1e-6, h=z, m=z - 10.0)


def _slstm_cell(params, cfg: XLSTMConfig, state: SLSTMState,
                wx_t: torch.Tensor) -> SLSTMState:
    """One timestep. wx_t: [B, 4 D], the precomputed input projection."""
    b = wx_t.shape[0]
    h_, dh = cfg.n_heads, cfg.head_dim
    rec = torch.einsum("bhd,hde->bhe", state.h.to(wx_t.dtype),
                       params["r_gates"].to(wx_t.dtype))     # [B, H, 4 Dh]
    gates = (wx_t.reshape(b, h_, 4 * dh) + rec
             + params["b_gates"].to(wx_t.dtype).reshape(h_, 4 * dh))
    z_pre, i_pre, f_pre, o_pre = torch.split(gates.to(F32), dh, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    lf = -softplus(-f_pre)            # log sigmoid(f_pre)
    li = i_pre
    m_new = torch.maximum(lf + state.m, li)
    i_g = torch.exp(li - m_new)
    f_g = torch.exp(lf + state.m - m_new)
    c_new = f_g * state.c + i_g * z
    n_new = f_g * state.n + i_g
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMState(c=c_new, n=n_new, h=h_new, m=m_new)


def _slstm_out(params, cfg: XLSTMConfig, hs: torch.Tensor, x_dtype):
    """hs: [B, S, H, Dh] hidden states -> [B, S, D]."""
    b, s = hs.shape[:2]
    hs = rmsnorm(params["head_norm"], hs).reshape(b, s, cfg.d_model)
    return torch.einsum("bse,ed->bsd", hs.to(x_dtype),
                        params["w_out"].to(x_dtype))


def slstm(params, cfg: XLSTMConfig, x: torch.Tensor,
          state: Optional[SLSTMState] = None):
    """Full-sequence sLSTM. x: [B, S, D] -> ([B, S, D], final state)."""
    b, s, _ = x.shape
    wx = torch.einsum("bsd,de->bse", x, params["w_gates"].to(x.dtype))
    if state is None:
        state = init_slstm_state(b, cfg, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, cfg, state, wx[:, t])
        hs.append(state.h)
    return _slstm_out(params, cfg, torch.stack(hs, dim=1), x.dtype), state
