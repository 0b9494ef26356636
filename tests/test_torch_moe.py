"""The port's MoE layer against the JAX package's ``models/moe.py``.

Routing and dropping are integer decisions, so they are held exactly: the
expert indices (``jax.lax.top_k``, the lower index first among equal
probabilities, here with ties planted on purpose), the kept mask after the
stable sort by expert, the capacity (Python's round, half to even) and the
dropped fraction, at capacity factor 4.0 (dropless) and 1.25 (with drops).
The layer's output and aux loss are float32 sums taken in another order:
rtol = atol = 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.spec import init_params as jax_init_params
from repro_torch import bridge
from repro_torch.models import moe as tmoe
from repro_torch.models.spec import init_params
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


@functools.cache
def _jax_params(d, f, e, k):
    """The JAX package's weights of one layer (they do not depend on the
    capacity factor), drawn once a shape."""
    desc = jmoe.moe_params(jmoe.MoEConfig(d_model=d, d_ff=f, n_experts=e,
                                          top_k=k))
    return jax.jit(lambda key: jax_init_params(key, desc))(
        jax.random.PRNGKey(0))


def _layer(d=32, f=48, e=8, k=2, cf=1.25):
    """(JAX config, JAX params, port config, port params): one layer with
    the JAX package's weights."""
    jcfg = jmoe.MoEConfig(d_model=d, d_ff=f, n_experts=e, top_k=k,
                          capacity_factor=cf)
    jparams = _jax_params(d, f, e, k)
    cfg = tmoe.MoEConfig(*jcfg)
    params = init_params(torch.Generator().manual_seed(0),
                         tmoe.moe_params(cfg))
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, cfg, params


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


# the JAX package's layer, one XLA program a configuration and shape
_jax_moe = jax.jit(jmoe.moe, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _jax_dispatch(jparams, jcfg, x):
    """The reference's routing and dispatch, its own lines (models/moe.py
    ``moe``, up to the capacity buffer): (expert_idx, order, keep)."""
    b, s, d = x.shape
    t, k, e = b * s, jcfg.top_k, jcfg.n_experts
    xf = x.reshape(t, d)
    logits = jnp.einsum("td,de->te", xf, jparams["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    flat_expert = expert_idx.reshape(-1)
    order = jnp.argsort(flat_expert)
    sorted_expert = flat_expert[order]
    counts = jnp.bincount(flat_expert, length=e)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(t * k) - starts[sorted_expert]
    cap = max(1, int(round(t * k / e * jcfg.capacity_factor)))
    return expert_idx, order, pos < cap


def _jax_routing(jparams, jcfg, x):
    """(expert_idx, order, keep, cap, dropped fraction) of the reference.
    The dropped fraction is the reference's line run eagerly, as the JAX
    package's tests run the layer: under ``jit`` XLA multiplies by the
    reciprocal of T k, an ulp off (-1.9e-8 where nothing drops)."""
    b, s, _ = x.shape
    idx, order, keep = _jax_dispatch(jparams, jcfg, x)
    t, k = b * s, jcfg.top_k
    cap = max(1, int(round(t * k / jcfg.n_experts * jcfg.capacity_factor)))
    dropped = 1.0 - jnp.sum(keep.astype(jnp.float32)) / (t * k)
    return (np.asarray(idx), np.asarray(order), np.asarray(keep), cap,
            float(dropped))


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("b,s", [(2, 16), (4, 1), (3, 7)])
def test_routing_and_drops_are_the_references(cf, b, s):
    jcfg, jparams, cfg, params = _layer(cf=cf)
    x = _x(b, s, 32, seed=s)
    want_idx, want_order, want_keep, want_cap, want_drop = _jax_routing(
        jparams, jcfg, jnp.asarray(x))
    xf = torch.from_numpy(x).reshape(b * s, 32)
    _, _, idx = tmoe.route(params, cfg, xf)
    dp = tmoe.dispatch(idx, cfg)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(dp.order.numpy(), want_order)
    np.testing.assert_array_equal(dp.keep.numpy(), want_keep)
    assert dp.cap == want_cap
    got = tmoe.moe(params, cfg, torch.from_numpy(x))
    assert float(got.dropped_frac) == want_drop
    if cf == 4.0:
        assert want_drop == 0.0
    elif (b, s) == (2, 16):
        assert want_drop > 0.0      # some assignments past capacity


@pytest.mark.parametrize("cf", [4.0, 1.25])
def test_output_and_aux_loss(cf):
    jcfg, jparams, cfg, params = _layer(cf=cf)
    x = _x(2, 16, 32, seed=5)
    want = _jax_moe(jparams, jcfg, jnp.asarray(x))
    got = tmoe.moe(params, cfg, torch.from_numpy(x))
    assert got.y.shape == (2, 16, 32) and got.y.dtype == torch.float32
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               **TOL)


def test_planted_ties_take_the_lower_expert_first():
    """Router columns 1 = 5 and 2 = 6 = 7: every token's probabilities tie
    in groups, and the top 4 must come as jax.lax.top_k gives them."""
    jcfg, jparams, cfg, params = _layer(k=4)
    router = np.asarray(jparams["router"]).copy()
    router[:, 5] = router[:, 1]
    router[:, 6] = router[:, 7] = router[:, 2]
    jparams = {**jparams, "router": jnp.asarray(router)}
    with torch.no_grad():
        params["router"].copy_(torch.from_numpy(router))
    x = _x(3, 11, 32, seed=9)
    want_idx, want_order, want_keep, _, _ = _jax_routing(
        jparams, jcfg, jnp.asarray(x))
    probs, _, idx = tmoe.route(params, cfg, torch.from_numpy(x).reshape(33,
                                                                         32))
    assert torch.equal(probs[:, 1], probs[:, 5])       # the ties are there
    assert torch.equal(probs[:, 6], probs[:, 7])
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    dp = tmoe.dispatch(idx, cfg)
    np.testing.assert_array_equal(dp.order.numpy(), want_order)
    np.testing.assert_array_equal(dp.keep.numpy(), want_keep)
    got = tmoe.moe(params, cfg, torch.from_numpy(x))
    want = _jax_moe(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)


def test_top_k_on_all_equal_probabilities():
    """A row of equal values: indices 0..k-1, as jax.lax.top_k."""
    probs = torch.full((3, 64), 1.0 / 64)
    _, idx = tmoe.top_k(probs, 6)
    want = jax.lax.top_k(jnp.full((3, 64), 1.0 / 64), 6)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    assert idx[0].tolist() == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("t,k,e,cf,want", [
    (4, 6, 64, 1.25, 1),       # moonshot's decode step at B = 4: capacity 1
    (4096, 6, 64, 1.25, 480),  # moonshot's prefill at T = 4,096
    (4096, 4, 16, 1.25, 1280),  # dbrx's
    (8, 2, 4, 1.25, 5),        # 5.0
    (4, 5, 8, 1.0, 2),         # 2.5 rounds half to even: 2
    (6, 5, 8, 1.0, 4),         # 3.75
])
def test_capacity_is_the_reference_expression(t, k, e, cf, want):
    cfg = tmoe.MoEConfig(d_model=8, d_ff=8, n_experts=e, top_k=k,
                         capacity_factor=cf)
    assert tmoe.capacity(t, cfg) == want
    assert want == max(1, int(round(t * k / e * cf)))


def test_moonshot_decode_step_drops_as_the_reference():
    """64 experts, top 6, B = 4 tokens: capacity 1, so two tokens routed to
    one expert drop one of them, in both packages alike."""
    jcfg, jparams, cfg, params = _layer(d=32, f=16, e=64, k=6)
    x = _x(4, 1, 32, seed=11)
    _, _, want_keep, cap, want_drop = _jax_routing(jparams, jcfg,
                                                   jnp.asarray(x))
    got = tmoe.moe(params, cfg, torch.from_numpy(x))
    assert cap == 1 and want_drop > 0.0
    assert float(got.dropped_frac) == want_drop
    want = _jax_moe(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), **TOL)


def test_moe_local_raises_for_the_mesh():
    """Expert-parallel dispatch over a mesh of two model ranks: with no
    drops it is the global dispatch (tests/test_torch_lm_mesh.py holds it
    against the JAX package's on 8 devices); only a ``device.Mesh`` is a
    mesh."""
    from repro_torch.device import Mesh
    jcfg, jparams, cfg, params = _layer()
    cfg = cfg._replace(capacity_factor=8.0)
    x = torch.from_numpy(_x(2, 6, 32, seed=4))
    mesh = Mesh((torch.device("cpu"),) * 2, ("data", "model"), (1, 2))
    got = tmoe.moe_local(params, cfg, x, mesh)
    want = tmoe.moe(params, cfg, x)
    assert float(got.dropped_frac) == float(want.dropped_frac) == 0.0
    np.testing.assert_allclose(got.y.numpy(), want.y.numpy(), **TOL)
    with pytest.raises(TypeError, match="device.Mesh"):
        tmoe.moe_local(params, cfg, torch.zeros(1, 2, 32), mesh=object())
