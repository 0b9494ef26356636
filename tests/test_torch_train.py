"""The training objective, port against the JAX package: ``loss`` and its
gradient with respect to every parameter, for one architecture of each
family (dense, vlm, moe, hybrid, ssm, audio), at the reduced configs
(2 layers, d_model 64, float32) with the JAX package's weights
(``PRNGKey(0)``) carried over by ``bridge.load_lm_params``, on numpy-made
tokens, labels and frames. The JAX side is ``jax.value_and_grad`` of
``model.loss``, jit-compiled, once per architecture.

Tolerances: loss, nll and aux at 2e-5 relative (xlstm 5e-4, its logits'
gap: tests/test_torch_families.py); each gradient leaf within 1e-4 of the
leaf's largest magnitude (xlstm 5e-3), compared leaf by leaf in the JAX
package's layout (``bridge.lm_leaves_to_numpy``).

Also: remat on equals remat off bit for bit; llama with bf16 activations
against the reference's bf16 loss (the embedding's gradient accumulates
in bf16 in both, the table being cast before the gather); the flash
kernel refuses to run under autograd and runs under ``torch.no_grad()``.
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
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import build_model, get_config, reduced_config
from repro_torch.models.layers import attention
from repro_torch.models.spec import tree_leaves
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ARCHS = ("llama3.2-1b", "chameleon-34b", "dbrx-132b", "hymba-1.5b",
         "xlstm-125m", "whisper-small")
LOSS_RTOL = {"xlstm-125m": 5e-4}
GRAD_REL = {"xlstm-125m": 5e-3}
B, S = 2, 24
# bf16 activations: the loss at bf16's resolution, each gradient leaf
# within 5% of its largest magnitude (bf16 rounding of every activation,
# summed in other orders by the two libraries); the embedding's leaf is
# printed beside the others' gap
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_REL = 5e-2


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    # repeated tokens, so that the embedding's gradient accumulates
    tokens[:, S // 2:] = tokens[:, :S - S // 2]
    batch = {"tokens": tokens,
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _setup(name, dtype=None):
    jcfg = jax_reduced(jax_get_config(name))
    cfg = reduced_config(get_config(name))
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jmodel, model = jax_build(jcfg), build_model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    params.requires_grad_(True)
    batch = _batch(cfg, 7)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss, has_aux=True))(jparams, batch)
    want = dict(loss=float(jloss), nll=float(jmetrics["nll"]),
                aux=float(jmetrics["aux"]),
                grads=jax.tree.map(np.asarray, jgrads))
    return model, params, batch, want


@pytest.fixture(scope="module")
def reference():
    """name -> (port model, its params, batch, the JAX loss and grads)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _setup(name)
        return cache[name]

    return get


def _loss_and_grads(model, params, batch):
    loss, metrics = model.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss, metrics, bridge.lm_leaves_to_numpy(model, grads)


def _grad_gaps(got, want):
    """(path, |got - want|_max / |want|_max) of every leaf."""
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree.leaves(got)
    assert len(flat_got) == len(flat_want)
    out = []
    for (path, w), g in zip(flat_want, flat_got):
        assert g.shape == w.shape, (jax.tree_util.keystr(path), g.shape,
                                    w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        out.append((jax.tree_util.keystr(path),
                    float(np.abs(g - w).max()) / scale))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference(reference, name):
    model, params, batch, want = reference(name)
    loss, metrics, grads = _loss_and_grads(model, params, batch)
    rtol = LOSS_RTOL.get(name, 2e-5)
    for key, value in (("loss", loss), ("nll", metrics["nll"]),
                       ("aux", metrics["aux"])):
        assert value.dtype == torch.float32 and value.shape == ()
        np.testing.assert_allclose(float(value.detach()), want[key],
                                   rtol=rtol, atol=1e-7, err_msg=key)
    if model.cfg.family == "moe":
        assert want["aux"] > 0.0
    bad = [(p, gap) for p, gap in _grad_gaps(grads, want["grads"])
           if gap > GRAD_REL.get(name, 1e-4)]
    assert not bad, bad


@pytest.mark.parametrize("name", ("llama3.2-1b", "dbrx-132b", "xlstm-125m"))
def test_remat_equals_no_remat(reference, name):
    model, params, batch, _ = reference(name)
    assert model.cfg.remat
    plain = build_model(dataclasses.replace(model.cfg, remat=False))
    got = _loss_and_grads(model, params, batch)
    want = _loss_and_grads(plain, params, batch)
    assert float(got[0].detach()) == float(want[0].detach())
    for g, w in zip(jax.tree.leaves(got[2]), jax.tree.leaves(want[2])):
        np.testing.assert_array_equal(g, w)


def test_bf16_loss_and_grads_match_reference():
    model, params, batch, want = _setup("llama3.2-1b", dtype=torch.bfloat16)
    loss, _, grads = _loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss.detach()), want["loss"],
                               rtol=BF16_LOSS_RTOL)
    gaps = _grad_gaps(grads, want["grads"])
    print("bf16 gradient gaps: " + ", ".join(f"{p} {g:.2e}"
                                             for p, g in gaps))
    bad = [(p, g) for p, g in gaps if g > BF16_GRAD_REL]
    assert not bad, bad


def test_flash_kernel_refuses_autograd():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 4, 16))
                                .astype(np.float32)) for _ in range(3))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention(q, k, v)
    with torch.no_grad():
        out = fa_ops.flash_attention(q, k, v)
    assert out.shape == q.shape and out.grad_fn is None

    cfg = reduced_config(get_config("llama3.2-1b"))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    params.requires_grad_(True)
    p = params["layers"][0]["attn"]
    x = torch.from_numpy(rng.standard_normal((1, 16, cfg.d_model))
                         .astype(np.float32))
    with pytest.raises(RuntimeError, match="no backward"):
        attention(p, cfg.attn_config(), x, use_kernel=True)
    with pytest.raises(RuntimeError, match="no backward"):
        build_model(dataclasses.replace(cfg, use_flash_kernel=True)).loss(
            params, _torch_batch(_batch(cfg, 1)))
    with torch.no_grad():
        got = attention(p, cfg.attn_config(), x, use_kernel=True)
        want = attention(p, cfg.attn_config(), x, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
