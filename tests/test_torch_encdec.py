"""The port's encoder-decoder (``models/encdec.py``) against the JAX
package's: ``sinusoidal``, ``encode``, the forward's two call forms, the
serving cache (``init_cache``'s zero cross K/V, ``prefill``'s prompt-sized
self-attention caches, ``decode_step``'s position from the cache length),
on a reduced whisper-small (2 + 2 layers, d_model 64, 24 frames, float32)
with the JAX package's weights.

Tolerances: float32 outputs at rtol = atol = 2e-5, bf16 caches within one
bf16 ulp. The two libraries' float32 ``exp`` differ by an ulp in the
sinusoid's frequencies, which a position multiplies: at whisper-small's
1,500 frames the embeddings are held to 1,500 x 1.2e-7 = 1.8e-4, at the
reduced 24 to 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import reduced_config as jax_reduced
from repro.models.encdec import sinusoidal as jax_sinusoidal
from repro_torch import bridge
from repro_torch.models import EncDecLM, build_model, get_config
from repro_torch.models import reduced_config
from repro_torch.models.encdec import sinusoidal
from repro_torch.models.layers import attention
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
B, S = 2, 10


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params): same weights."""
    jmodel = jax_build(jax_reduced(jax_get_config("whisper-small")))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(reduced_config(get_config("whisper-small")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _inputs(seed, s=S):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, s)).astype(np.int32),
            rng.standard_normal((B, 24, 64)).astype(np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("n,d,atol", [(24, 64, 2e-5), (1500, 768, 1.8e-4)])
def test_sinusoidal(n, d, atol):
    pos = np.arange(n)
    got = sinusoidal(torch.from_numpy(pos), d, torch.float32)
    assert got.shape == (n, d) and got.dtype == torch.float32
    _close(got, jax_sinusoidal(jnp.asarray(pos), d, jnp.float32),
           dict(rtol=0, atol=atol))
    assert sinusoidal(torch.from_numpy(pos), d, torch.bfloat16).dtype == \
        torch.bfloat16


def test_the_model_is_an_encoder_decoder():
    model = build_model(get_config("whisper-small"))
    assert isinstance(model, EncDecLM)
    assert (model.n_params() == model.n_active_params()
            == jax_build(jax_get_config("whisper-small")).n_params())


def test_encode(pair):
    jmodel, jparams, model, params = pair
    _, frames = _inputs(1)
    got = model.encode(params, torch.from_numpy(frames))
    assert got.shape == (B, 24, 64)
    _close(got, jax.jit(jmodel.encode)(jparams, jnp.asarray(frames)))


def test_forward_takes_a_batch_or_tokens_and_frames(pair):
    _, _, model, params = pair
    tok, frames = map(torch.from_numpy, _inputs(2))
    a = model.forward(params, {"tokens": tok, "frames": frames})
    b = model.forward(params, tok, frames=frames)
    assert torch.equal(a, b) and a.shape == (B, S, 256)
    with pytest.raises(TypeError, match="device.Mesh"):
        model.forward(params, tok, mesh=object(), frames=frames)


def test_init_cache_holds_zero_cross_kv(pair):
    jmodel, _, model, _ = pair
    cache = model.init_cache(3, 16, device="cpu")
    want = jmodel.init_cache(3, 16)
    assert int(cache.length) == 0 and cache.length.dtype == torch.int32
    assert len(cache.self_kv) == len(cache.cross_kv) == 2
    for (k, v), (jk, jv) in zip(cache.cross_kv, want.cross_kv):
        assert k.shape == jk.shape == (3, 24, 4, 16)
        assert k.dtype == v.dtype == torch.bfloat16
        assert not k.any() and not v.any()
    assert cache.self_kv[0].k.shape == want.self_kv[0].k.shape == (3, 16, 4,
                                                                  16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_cache(1, 4)


def test_zero_cross_kv_contributes_nothing(pair):
    """Against the empty cache's zero K/V the cross-attention softmax is
    uniform over zeros: its output is exactly zero, in both packages."""
    _, _, model, params = pair
    p = params["decoder"][0]["cross_attn"]
    h = torch.from_numpy(_inputs(3)[1][:, :1])
    z = torch.zeros((B, 24, 4, 16))
    out = attention(p, model._attn_cfg(False), h, kv=(z, z))
    assert not out.any()


def test_prefill_then_decode_from_its_cache(pair):
    """prefill's logits and caches (the self-attention K/V sized to the
    prompt, length = S, as the reference leaves them); then one decode step
    on each package's own prefilled cache, padded by one slot, whose
    position is the cache's length (sinusoidal(S)): the forward's logits
    at S within the bf16 caches' error."""
    jmodel, jparams, model, params = pair
    tok, frames = _inputs(4, S + 1)
    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tok[:, :S]),
                                     frames=jnp.asarray(frames))
    tl, tc = model.prefill(params, torch.from_numpy(tok[:, :S]),
                           frames=torch.from_numpy(frames))
    _close(tl, jl)
    assert int(tc.length) == S
    for kv, jkv in zip(tc.self_kv, jc.self_kv):
        assert kv.k.shape == (B, S, 4, 16) and kv.k.dtype == torch.bfloat16
        _close(kv.k, jkv.k, BF16_ULP)
        _close(kv.v, jkv.v, BF16_ULP)
    for (k, v), (jk, jv) in zip(tc.cross_kv, jc.cross_kv):
        _close(k, jk, BF16_ULP)
        _close(v, jv, BF16_ULP)

    def pad(kv):
        z = torch.zeros((B, 1, 4, 16), dtype=kv.k.dtype)
        return kv._replace(k=torch.cat([kv.k, z], 1),
                           v=torch.cat([kv.v, z], 1))

    tc = tc._replace(self_kv=[pad(kv) for kv in tc.self_kv])
    got, tc = model.decode_step(params, torch.from_numpy(tok[:, S]), tc)
    assert int(tc.length) == S + 1
    full = model.forward(params, torch.from_numpy(tok),
                         frames=torch.from_numpy(frames))[:, S]
    _close(got, full, dict(rtol=2e-2, atol=2e-2))
