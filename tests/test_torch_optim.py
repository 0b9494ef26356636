"""AdamW and the int8 gradient compression, port against the JAX package
(``repro.optim.adamw``, ``repro.optim.compression``), fed the same numpy
parameters and gradients.

* ``schedule`` across warmup and decay, ``global_norm``, clipping with the
  norm above and below ``clip_norm``, and three ``apply_updates`` steps:
  parameters, m and v at 1e-6 relative.
* ``_quantize_dequantize`` bit for bit, on sizes that are not a multiple
  of the 256-element block and with planted .5 ties (both libraries round
  half to even); ``compress_with_feedback`` over three steps.
* Mirrors of the JAX package's own optimizer tests
  (tests/test_checkpoint_ft.py ``TestOptimizer``) on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import adamw, compression
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (7, 33), "b": {"c": (300,), "d": (5, 4, 3)}}


def _tree(rng, scale=1.0):
    """A nested dict of float32 arrays of ``SHAPES``."""
    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        return (scale * rng.standard_normal(node)).astype(np.float32)
    return make(SHAPES)


def _t(tree):
    """The same dict of tensors (copies, so the port's in-place updates
    leave the numpy arrays alone)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(tree)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(warmup_steps=10, total_steps=50),
    adamw.AdamWConfig(warmup_steps=0, total_steps=7),
    adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=3),
])
def test_schedule_matches_reference(cfg):
    jcfg = jadamw.AdamWConfig(*cfg)
    for step in range(0, cfg.total_steps + 5):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(0))
    np.testing.assert_allclose(float(adamw.global_norm(_t(tree))),
                               float(jadamw.global_norm(tree)), **TOL)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])   # below / above clip
@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_reference_over_three_steps(grad_scale,
                                                          compress):
    rng = np.random.default_rng(1)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jadamw.AdamWConfig(*cfg)
    jparams = _tree(rng)
    params = _t(jparams)
    jstate, state = jadamw.init_opt_state(jparams), adamw.init_opt_state(
        params)
    jef = jcomp.init_error_feedback(jparams)
    ef = compression.init_error_feedback(params)
    for _ in range(3):
        grads = _tree(rng, grad_scale)
        jgrads = grads
        tgrads = [torch.tensor(x) for x in _np_leaves(grads)]
        if compress:
            jgrads, jef = jcomp.compress_with_feedback(jgrads, jef)
            tgrads, ef = compression.compress_with_feedback(tgrads, ef)
        jparams, jstate, jm = jadamw.apply_updates(jcfg, jparams, jgrads,
                                                   jstate)
        params, state, m = adamw.apply_updates(cfg, params, tgrads, state)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), **TOL)
        assert int(state.step) == int(jstate.step)
        for got, want in ((_port_leaves(params), _np_leaves(jparams)),
                          ([x.numpy() for x in state.m],
                           _np_leaves(jstate.m)),
                          ([x.numpy() for x in state.v],
                           _np_leaves(jstate.v))):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, **TOL)
    if grad_scale > 1.0:
        assert float(m["grad_norm"]) > cfg.clip_norm


def _planted(n, seed):
    """Gradients whose first block has entries exactly on .5 of the int8
    grid: the block's largest magnitude is 127, so its scale is 1 (+1e-12,
    which does not move a float32 of this size), and k + .5 rounds to the
    even neighbour."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    m = min(n, 256)
    g[:m] = rng.integers(-126, 126, m) + 0.5
    g[0] = 127.0
    return g


@pytest.mark.parametrize("shape", [(1,), (255,), (257,), (3, 300),
                                   (4, 256), (2, 3, 129)])
def test_quantize_dequantize_bit_for_bit(shape):
    n = int(np.prod(shape))
    g = _planted(n, n).reshape(shape)
    want = np.asarray(jcomp._quantize_dequantize(jnp.asarray(g)))
    got = compression._quantize_dequantize(torch.tensor(g)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    if n >= 3:   # the ties went to the even neighbour
        ties = g.reshape(-1)[1:min(n, 256)]
        np.testing.assert_array_equal(got.reshape(-1)[1:min(n, 256)],
                                      np.round(ties))


def test_compress_with_feedback_matches_reference_over_three_steps():
    rng = np.random.default_rng(2)
    jgrads = _tree(rng)
    jef = jcomp.init_error_feedback(jgrads)
    ef = compression.init_error_feedback(_t(jgrads))
    for step in range(3):
        grads = _tree(rng)
        grads["a"][0, :5] = np.float32(0.5) * np.arange(5)
        jc, jef = jcomp.compress_with_feedback(grads, jef)
        c, ef = compression.compress_with_feedback(
            [torch.tensor(x) for x in _np_leaves(grads)], ef)
        for g, w in zip([x.numpy() for x in c], _np_leaves(jc)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip([x.numpy() for x in ef.residual],
                        _np_leaves(jef.residual)):
            np.testing.assert_array_equal(g, w)


# -- mirrors of the JAX package's optimizer tests ----------------------------

def test_adamw_decreases_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                            weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2.0 * params["w"]}
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 1.0


def test_grad_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = adamw.init_opt_state(params)
    _, _, metrics = adamw.apply_updates(cfg, params,
                                        {"w": torch.full((3,), 1e6)}, state)
    assert float(metrics["grad_norm"]) > 1e5  # norm reported pre-clip


def test_compression_error_feedback_preserves_sum():
    g = [torch.linspace(-1.0, 1.0, 1000)]
    ef = compression.init_error_feedback(g)
    total_c = torch.zeros(1000)
    for _ in range(20):
        c, ef = compression.compress_with_feedback(g, ef)
        total_c = total_c + c[0]
    err = (total_c + ef.residual[0] - 20.0 * g[0]).abs().max()
    assert float(err) < 1e-3
