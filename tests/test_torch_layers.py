"""The port's transformer layers against the JAX package's, in float32, on
numpy-made inputs and parameters handed to both.

Tolerances: rtol = atol = 1e-5 for norms, RoPE and the MLP (float32
rounding of the same formulas); 2e-5 for attention (float32 sums taken in
another order). RoPE positions stay at most 64: float32 ``theta ** e``
differs by an ulp between XLA and PyTorch, which a large position multiplies
(ROADMAP Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models.spec import Params
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


def _arr(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _params(tree_np):
    """The same parameter dict for both packages: (jax, port)."""
    def port(node):
        return Params({k: port(v) if isinstance(v, dict)
                       else torch.from_numpy(v) for k, v in node.items()})
    return jax.tree.map(jnp.asarray, tree_np), port(tree_np)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _attn_params(rng, cfg):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / np.sqrt(d)
    tree = {"wq": _arr(rng, d, h, dh, scale=s),
            "wk": _arr(rng, d, kv, dh, scale=s),
            "wv": _arr(rng, d, kv, dh, scale=s),
            "wo": _arr(rng, h, dh, d, scale=1.0 / np.sqrt(h * dh))}
    if cfg.qk_norm:
        tree["q_norm"] = {"scale": 1.0 + _arr(rng, dh, scale=0.1)}
        tree["k_norm"] = {"scale": 1.0 + _arr(rng, dh, scale=0.1)}
    return _params(tree)


def _cfgs(**kw):
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
    base.update(kw)
    return JL.AttnConfig(**base), TL.AttnConfig(**base)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = _arr(rng, 2, 5, 64, scale=3.0)
    jp, tp = _params({"scale": 1.0 + _arr(rng, 64, scale=0.2)})
    _close(TL.rmsnorm(tp, torch.from_numpy(x)), JL.rmsnorm(jp, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 5e5])
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope(theta, batched_positions):
    rng = np.random.default_rng(1)
    x = _arr(rng, 2, 65, 4, 64)
    pos = np.arange(65, dtype=np.int32)
    if batched_positions:
        pos = np.stack([pos, pos[::-1]])
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))


VARIANTS = [dict(), dict(qk_norm=True), dict(window=8), dict(causal=False),
            dict(rope_theta=5e5)]


# (the flash lane refuses non-causal attention over 24 keys in both
# packages: test_torch_attention_kernels.py holds that refusal)
@pytest.mark.parametrize("lane,variant", [
    (lane, v) for lane in ("einsum", "chunked", "flash") for v in VARIANTS
    if lane != "flash" or v.get("causal", True)])
def test_attention_lanes(lane, variant):
    chunk = 8 if lane == "chunked" else 0
    jcfg, tcfg = _cfgs(chunk=chunk, **variant)
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(rng, tcfg)
    x = _arr(rng, 2, 24, 64)
    use_kernel = lane == "flash"
    got = TL.attention(tp, tcfg, torch.from_numpy(x), use_kernel=use_kernel)
    want = JL.attention(jp, jcfg, jnp.asarray(x), use_kernel=use_kernel)
    _close(got, want, ATTN_TOL)


def test_chunked_falls_back_when_chunk_does_not_divide():
    jcfg, tcfg = _cfgs(chunk=7)
    rng = np.random.default_rng(3)
    jp, tp = _attn_params(rng, tcfg)
    x = _arr(rng, 1, 24, 64)
    _close(TL.attention(tp, tcfg, torch.from_numpy(x)),
           JL.attention(jp, jcfg, jnp.asarray(x)), ATTN_TOL)


def _decode_both(jcfg, tcfg, steps, size, use_kernel, seed=4):
    """Teacher-forced decode of ``steps`` positions through both packages
    from an empty float32 cache of ``size`` slots; returns the outputs and
    final caches."""
    rng = np.random.default_rng(seed)
    jp, tp = _attn_params(rng, tcfg)
    jc = JL.init_kv_cache(2, size, jcfg, jnp.float32)
    tc = TL.init_kv_cache(2, size, tcfg, torch.float32, device="cpu")
    outs = []
    for _ in range(steps):
        x = _arr(rng, 2, 1, 64)
        jo, jc = JL.attention_decode(jp, jcfg, jnp.asarray(x), jc,
                                     use_kernel=use_kernel)
        to, tc = TL.attention_decode(tp, tcfg, torch.from_numpy(x), tc,
                                     use_kernel=use_kernel)
        outs.append((to, jo))
    return outs, tc, jc


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("window,size,steps", [
    (0, 16, 10),       # plain cache, partly filled
    (6, 6, 14),        # rolling window buffer, wrapped twice
    (0, 5, 9),         # writes past the end clamp onto the last slot
])
def test_attention_decode(use_kernel, window, size, steps):
    jcfg, tcfg = _cfgs(window=window)
    outs, tc, jc = _decode_both(jcfg, tcfg, steps, size, use_kernel)
    for got, want in outs:
        _close(got, want, ATTN_TOL)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    assert int(tc.length) == int(jc.length) == steps


def test_cache_update_clamps_like_dynamic_update_slice():
    cache = torch.zeros(1, 4, 1, 2)
    new = torch.ones(1, 1, 1, 2)
    for slot, want_row in ((0, 0), (2, 2), (3, 3), (4, 3), (9, 3)):
        got = TL._cache_update(cache.clone(), new, torch.tensor(slot))
        ref = jax.lax.dynamic_update_slice(
            jnp.zeros((1, 4, 1, 2)), jnp.ones((1, 1, 1, 2)),
            (0, slot, 0, 0))
        _close(got, ref)
        assert float(got[0, want_row].sum()) == 2.0


def test_cache_update_with_a_mesh_is_not_ported():
    """A mesh whose model axis shards the cache's sequence takes the JAX
    package's owner-rank write (tests/test_torch_lm_mesh.py holds it against
    the JAX package's shard_map write): in range it is the plain write, at S
    it writes nothing, where the plain write clamps onto the last entry."""
    from repro_torch.device import Mesh
    from repro_torch.models.spec import NamedSharding, PartitionSpec, put
    mesh = Mesh((torch.device("cpu"),) * 2, ("data", "model"), (1, 2))
    for slot, want_row in ((1, 1), (4, None)):
        plain = TL._cache_update(torch.zeros(1, 4, 1, 2),
                                 torch.ones(1, 1, 1, 2), torch.tensor(slot))
        got = TL._cache_update(torch.zeros(1, 4, 1, 2),
                               torch.ones(1, 1, 1, 2), torch.tensor(slot),
                               mesh=mesh)
        sharded = put(torch.zeros(1, 4, 1, 2),
                      NamedSharding(mesh, PartitionSpec(None, "model")))
        TL._cache_update(sharded, torch.ones(1, 1, 1, 2), torch.tensor(slot),
                         mesh=mesh)
        assert torch.equal(sharded.gather(), got)
        if want_row is None:
            assert not bool(got.any()) and float(plain[0, 3].sum()) == 2.0
        else:
            assert torch.equal(got, plain)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(5)
    tree = {"w_in": _arr(rng, 64, 128, scale=0.125),
            "w_out": _arr(rng, 128, 64, scale=0.09)}
    if gated:
        tree["w_gate"] = _arr(rng, 64, 128, scale=0.125)
    jp, tp = _params(tree)
    x = _arr(rng, 2, 7, 64, scale=2.0)
    _close(TL.mlp(tp, torch.from_numpy(x)), JL.mlp(jp, jnp.asarray(x)))


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the port's MLP too."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    jp, tp = _params({"w_in": np.eye(101, dtype=np.float32),
                      "w_out": np.eye(101, dtype=np.float32)})
    got = TL.mlp(tp, torch.from_numpy(x)[None, None])
    _close(got[0, 0], jax.nn.gelu(jnp.asarray(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((got[0, 0] - exact).abs().max()) > 1e-4


def test_init_kv_cache_runs_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    """Without ``device`` the cache goes to the card, and without a card
    that raises, as every entry point does; ``device="cpu"`` works."""
    _, tcfg = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.init_kv_cache(2, 8, tcfg, torch.float32)
    cache = TL.init_kv_cache(2, 8, tcfg, torch.float32, device="cpu")
    assert cache.k.device.type == "cpu" and cache.v.shape == (2, 8, 2, 16)
    assert int(cache.length) == 0 and not bool(cache.k.any())


def test_kv_cache_crosses_the_bridge():
    jcfg, tcfg = _cfgs()
    jc = JL.init_kv_cache(2, 8, jcfg, jnp.bfloat16)
    jc = jc._replace(k=jc.k.at[0, 3].set(1.5), length=jnp.int32(4))
    tc = bridge.from_reference(jax.tree.map(np.asarray, jc))
    assert isinstance(tc, TL.KVCache)
    assert tc.k.dtype == torch.bfloat16 and tuple(tc.k.shape) == (2, 8, 2, 16)
    assert float(tc.k[0, 3].float().min()) == 1.5 and int(tc.length) == 4
