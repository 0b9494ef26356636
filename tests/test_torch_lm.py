"""The port's decoder LM against the JAX package's: a reduced llama3.2-1b
(2 layers, d_model 64, float32) with the JAX package's weights carried over
by ``bridge.load_lm_params``, on numpy-made tokens.

Tolerances: logits at rtol = atol = 2e-5 (float32, sums taken in another
order); after a prefill, whose cache is bf16 in both packages, 1e-4, and
the bf16 caches within one bf16 ulp. The
full-width config is checked by parameter count only (no weights are
materialised here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import reduced_config as jax_reduced
from repro_torch import bridge
from repro_torch.configs.llama3_2_1b import CONFIG
from repro_torch.models import (ARCH_NAMES, DecoderLM, build_model,
                                get_config, reduced_config)
from repro_torch.models.spec import init_params

TOL = dict(rtol=2e-5, atol=2e-5)
# one bf16 ulp: float32 keys that differ in the last bits can round to
# neighbouring bf16 values
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): same weights."""
    jcfg = jax_reduced(jax_get_config("llama3.2-1b"))
    jmodel = jax_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(get_config("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _tokens(b, s, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("b,s", [(2, 16), (1, 37)])
def test_forward(pair, flash, b, s):
    jmodel, jparams, model, params = pair
    if flash:
        jmodel = jax_build(dataclasses.replace(jmodel.cfg,
                                               use_flash_kernel=True))
        model = DecoderLM(dataclasses.replace(model.cfg,
                                              use_flash_kernel=True))
    tok = _tokens(b, s, seed=s)
    got = model.forward(params, torch.from_numpy(tok))
    assert got.shape == (b, s, 256) and got.dtype == torch.float32
    _close(got, jmodel.forward(jparams, jnp.asarray(tok)))


def test_decode_step_teacher_forced(pair):
    jmodel, jparams, model, params = pair
    tok = _tokens(2, 12, seed=1)
    jc = jmodel.init_cache(2, 16, dtype=jnp.float32)
    tc = model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    for t in range(tok.shape[1]):
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(tok[:, t]), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok[:, t]), tc)
        assert tl.dtype == torch.float32 and tl.shape == (2, 256)
        _close(tl, jl)
    # the last position's logits equal the full forward's
    _close(tl, model.forward(params, torch.from_numpy(tok))[:, -1])
    for layer in range(model.cfg.n_layers):
        _close(tc[layer].k, jc.k[layer])
        assert int(tc[layer].length) == int(jc.length[layer]) == 12


@pytest.mark.parametrize("window", [0, 4])
def test_prefill_then_decode(pair, window):
    """prefill's logits and bf16 caches, then one decode step. Without a
    window it writes at slot S of the S-slot cache: XLA clamps the write
    onto the last slot, and the port does the same. With a window the cache
    is a rolling buffer of the last ``window`` positions."""
    jmodel, jparams, model, params = pair
    if window:
        jmodel = jax_build(dataclasses.replace(jmodel.cfg, window=window))
        model = DecoderLM(dataclasses.replace(model.cfg, window=window))
    tok = _tokens(2, 9, seed=2)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tok))
    tl, tc = model.prefill(params, torch.from_numpy(tok))
    _close(tl, jl)
    for layer in range(model.cfg.n_layers):
        assert tc[layer].k.dtype == torch.bfloat16
        assert tc[layer].k.shape[1] == (window or 9)
        _close(tc[layer].k, jc.k[layer], BF16_ULP)
        _close(tc[layer].v, jc.v[layer], BF16_ULP)
        assert int(tc[layer].length) == 9
    nxt = _tokens(2, 1, seed=3)[:, 0]
    jl, jc = jmodel.decode_step(jparams, jnp.asarray(nxt), jc)
    tl, tc = model.decode_step(params, torch.from_numpy(nxt), tc)
    _close(tl, jl, dict(rtol=1e-4, atol=1e-4))
    for layer in range(model.cfg.n_layers):
        _close(tc[layer].k, jc.k[layer], BF16_ULP)


def test_n_params_matches_the_reference():
    assert (DecoderLM(CONFIG).n_params()
            == jax_build(jax_get_config("llama3.2-1b")).n_params()
            == 1_235_814_400)
    red = reduced_config(CONFIG)
    assert (build_model(red).n_params()
            == jax_build(jax_reduced(jax_get_config("llama3.2-1b")))
            .n_params())


def test_config_is_the_reference_config():
    want = jax_get_config("llama3.2-1b")
    for field in dataclasses.fields(CONFIG):
        if field.name != "dtype":
            assert getattr(CONFIG, field.name) == getattr(want, field.name)
    assert CONFIG.dtype == torch.bfloat16 and ARCH_NAMES == ("llama3.2-1b",)


def test_init_statistics():
    """Fan-in scaled normals, ones for the norms, float32 by default and
    the requested dtype otherwise; a seed gives the same weights."""
    model = build_model(dataclasses.replace(
        reduced_config(CONFIG), d_model=128, d_ff=512, vocab=4096))
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert params["embed"].dtype == torch.float32
    assert not any(p.requires_grad for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) == model.n_params()
    layer = params["layers"][0]
    for w, fan_in, scale in ((params["embed"], 4096, 1.0),
                             (layer["attn"]["wq"], 128 * 4, 1.0),
                             (layer["attn"]["wo"], 4 * 16, 1.0),
                             (layer["ffn"]["w_out"], 512, 1.0)):
        std = scale / np.sqrt(fan_in)
        assert abs(float(w.mean())) < 0.05 * std
        assert abs(float(w.std()) / std - 1.0) < 0.05
    assert torch.equal(layer["ln1"]["scale"], torch.ones(128))
    again = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    bf16 = init_params(torch.Generator().manual_seed(3),
                       model.param_descriptors(), torch.bfloat16)
    assert bf16["embed"].dtype == torch.bfloat16


def test_unported_families_and_archs_raise():
    with pytest.raises(NotImplementedError, match="Queue A, item 10"):
        DecoderLM(dataclasses.replace(CONFIG, family="moe"))
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("qwen3-14b")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default does not raise")
    model = build_model(reduced_config(CONFIG))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(1, 4)


def test_load_lm_params_checks_shapes(pair):
    jmodel, jparams, model, params = pair
    tree = jax.tree.map(np.asarray, jparams)
    tree["embed"] = tree["embed"][:, :32]
    with pytest.raises(ValueError, match="embed"):
        bridge.load_lm_params(params, tree)
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"] = jax.tree.map(lambda a: a[:1], tree["layers"])
    with pytest.raises(ValueError, match="layers"):
        bridge.load_lm_params(params, tree)
