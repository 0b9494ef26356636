"""The port's SSM (``models/ssm.py``) and xLSTM (``models/xlstm.py``)
blocks against the JAX package's, with the JAX package's weights carried
over by ``bridge.load_lm_params``, on numpy-made inputs.

* ``_causal_conv`` (with and without a carry), ``_gates`` and ``ssd_scan``
  (chunks of 4 at S = 16, and S equal to the chunk; a misaligned length is
  refused as the reference asserts).
* ``ssm`` and ``ssm_decode`` chained over S steps, against the reference
  and against the full-sequence pass.
* ``mlstm`` / ``mlstm_decode``, ``slstm`` (output and final state) and one
  ``_slstm_cell`` step.

Tolerance: 1e-5 (float32; the two libraries' log, exp and einsums differ
in the last bits). The JAX functions are jit-compiled, one program a
configuration.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.models.spec import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.models.spec import init_params
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, H = 2, 16, 64, 4


@functools.cache
def _jax_params(kind):
    """The JAX package's weights of one block (``ssm``, ``mlstm`` or
    ``slstm``; they do not depend on the chunk), drawn once."""
    if kind == "ssm":
        desc = jssm.ssm_params(jssm.SSMConfig(D, D, H, 8))
    else:
        desc = getattr(jxl, f"{kind}_params")(jxl.XLSTMConfig(D, H))
    return jax.jit(lambda key: jax_init_params(key, desc))(
        jax.random.PRNGKey(0))


def _params(kind, tdesc):
    """(JAX params, port params): the JAX package's weights in both."""
    jparams = _jax_params(kind)
    params = init_params(torch.Generator().manual_seed(0), tdesc)
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jparams, params


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _ssm_pair(chunk=128):
    jcfg = jssm.SSMConfig(d_model=D, d_inner=D, n_heads=H, state=8,
                          chunk=chunk)
    cfg = tssm.SSMConfig(*jcfg)
    return (jcfg, cfg, *_params("ssm", tssm.ssm_params(cfg)))


def _xlstm_pair(kind, chunk=128):
    jcfg = jxl.XLSTMConfig(d_model=D, n_heads=H, chunk=chunk)
    cfg = txl.XLSTMConfig(*jcfg)
    return (jcfg, cfg, *_params(kind, getattr(txl, f"{kind}_params")(cfg)))


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv(with_carry):
    x, w = _x((B, S, D), 1), _x((4, D), 2, 0.5)
    carry = _x((B, 3, D), 3) if with_carry else None
    jy, jc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               None if carry is None else jnp.asarray(carry))
    ty, tc = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               None if carry is None
                               else torch.from_numpy(carry))
    _close(ty, jy)
    _close(tc, jc, dict(rtol=0, atol=0))


def test_gates():
    jcfg, cfg, jparams, params = _ssm_pair()
    x = _x((B, S, D), 4)
    want = jax.jit(jssm._gates, static_argnums=1)(jparams, jcfg,
                                                  jnp.asarray(x))
    got = tssm._gates(params, cfg, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w)


def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 1.0, (B, s, H)).astype(np.float32)
    dt = rng.uniform(0.0, 1.0, (B, s, H)).astype(np.float32)
    bm, cm = (rng.standard_normal((B, s, H, 8)).astype(np.float32)
              for _ in range(2))
    v = rng.standard_normal((B, s, H, 16)).astype(np.float32)
    return a, dt, bm, cm, v


@pytest.mark.parametrize("s,chunk", [(16, 4), (16, 16), (8, 128)])
def test_ssd_scan(s, chunk):
    args = _scan_inputs(s, seed=s + chunk)
    jy, jh = jax.jit(jssm.ssd_scan, static_argnums=5)(
        *map(jnp.asarray, args), chunk)
    ty, th = tssm.ssd_scan(*map(torch.from_numpy, args), chunk)
    assert ty.shape == (B, s, H, 16) and th.shape == (B, H, 8, 16)
    assert th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


def test_ssd_scan_carries_a_state_across_calls():
    """Two halves with the first's final state as the second's h0 equal the
    whole sequence in one scan."""
    args = [torch.from_numpy(a) for a in _scan_inputs(16, seed=7)]
    y, h = tssm.ssd_scan(*args, 4)
    y1, h1 = tssm.ssd_scan(*(a[:, :8] for a in args), 4)
    y2, h2 = tssm.ssd_scan(*(a[:, 8:] for a in args), 4, h0=h1)
    _close(torch.cat([y1, y2], 1), y.numpy())
    _close(h2, h.numpy())


def test_ssd_scan_refuses_a_misaligned_length():
    args = [torch.from_numpy(a) for a in _scan_inputs(10, seed=1)]
    with pytest.raises(ValueError, match="not divisible by chunk 4"):
        tssm.ssd_scan(*args, 4)


@pytest.mark.parametrize("chunk", [4, 128])
def test_ssm_and_ssm_decode(chunk):
    """The full pass, and S decode steps from an empty cache, each against
    the reference; the chained steps also equal the full pass."""
    jcfg, cfg, jparams, params = _ssm_pair(chunk)
    x = _x((B, S, D), 5)
    full = tssm.ssm(params, cfg, torch.from_numpy(x))
    _close(full, jax.jit(jssm.ssm, static_argnums=1)(jparams, jcfg,
                                                      jnp.asarray(x)))
    jstep = jax.jit(jssm.ssm_decode, static_argnums=1)
    jc = jssm.init_ssm_cache(B, jcfg, jnp.float32)
    tc = tssm.init_ssm_cache(B, cfg, torch.float32, device="cpu")
    outs = []
    for t in range(S):
        jo, jc = jstep(jparams, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = tssm.ssm_decode(params, cfg, torch.from_numpy(
            x[:, t:t + 1]), tc)
        _close(to, jo)
        outs.append(to)
    _close(tc.h, jc.h)
    _close(tc.conv, jc.conv)
    _close(torch.cat(outs, 1), full.numpy())


def test_caches_and_states_start_as_the_reference():
    jcfg, cfg = jssm.SSMConfig(D, D, H, 8), tssm.SSMConfig(D, D, H, 8)
    for got, want in ((tssm.init_ssm_cache(3, cfg, device="cpu"),
                       jssm.init_ssm_cache(3, jcfg)),
                      (txl.init_mlstm_cache(3, txl.XLSTMConfig(D, H),
                                            device="cpu"),
                       jxl.init_mlstm_cache(3, jxl.XLSTMConfig(D, H))),
                      (txl.init_slstm_state(3, txl.XLSTMConfig(D, H),
                                            device="cpu"),
                       jxl.init_slstm_state(3, jxl.XLSTMConfig(D, H)))):
        assert type(got).__name__ == type(want).__name__
        for g, w in zip(got, want):
            assert g.dtype == bridge._tensor(np.asarray(w)).dtype
            _close(g, w, dict(rtol=0, atol=0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tssm.init_ssm_cache(1, cfg)


@pytest.mark.parametrize("chunk", [4, 128])
def test_mlstm_and_mlstm_decode(chunk):
    jcfg, cfg, jparams, params = _xlstm_pair("mlstm", chunk)
    x = _x((B, S, D), 6)
    full = txl.mlstm(params, cfg, torch.from_numpy(x))
    _close(full, jax.jit(jxl.mlstm, static_argnums=1)(jparams, jcfg,
                                                       jnp.asarray(x)))
    jstep = jax.jit(jxl.mlstm_decode, static_argnums=1)
    jc = jxl.init_mlstm_cache(B, jcfg)
    tc = txl.init_mlstm_cache(B, cfg, device="cpu")
    outs = []
    for t in range(S):
        jo, jc = jstep(jparams, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        to, tc = txl.mlstm_decode(params, cfg, torch.from_numpy(
            x[:, t:t + 1]), tc)
        _close(to, jo)
        outs.append(to)
    _close(tc.h, jc.h)
    _close(torch.cat(outs, 1), full.numpy())


def test_slstm():
    jcfg, cfg, jparams, params = _xlstm_pair("slstm")
    x = _x((B, S, D), 8)
    jo, js = jax.jit(jxl.slstm, static_argnums=1)(jparams, jcfg,
                                                   jnp.asarray(x))
    to, ts = txl.slstm(params, cfg, torch.from_numpy(x))
    _close(to, jo)
    for g, w in zip(ts, js):
        _close(g, w)
    # the state carries: two halves equal the whole
    o1, s1 = txl.slstm(params, cfg, torch.from_numpy(x[:, :8]))
    o2, s2 = txl.slstm(params, cfg, torch.from_numpy(x[:, 8:]), s1)
    _close(torch.cat([o1, o2], 1), to.numpy())


def test_slstm_cell():
    jcfg, cfg, jparams, params = _xlstm_pair("slstm")
    rng = np.random.default_rng(9)
    state = [rng.standard_normal((B, H, 16)).astype(np.float32)
             for _ in range(4)]
    state[1] = np.abs(state[1]) + 0.5           # n > 0
    wx = _x((B, 4 * D), 10)
    want = jax.jit(jxl._slstm_cell, static_argnums=1)(
        jparams, jcfg, jxl.SLSTMState(*map(jnp.asarray, state)),
        jnp.asarray(wx))
    got = txl._slstm_cell(params, cfg, txl.SLSTMState(
        *map(torch.from_numpy, state)), torch.from_numpy(wx))
    for g, w in zip(got, want):
        _close(g, w)
