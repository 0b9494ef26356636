"""Every architecture of the registry, port against the JAX package: the
reduced configs (2 layers, d_model 64, float32) with the JAX package's
weights (``PRNGKey(0)``) carried over by ``bridge.load_lm_params``, on
numpy-made tokens and frames.

* The full-width configs equal the reference field by field, and so do
  their parameter counts (total and active).
* ``forward`` with the flash flag off and on (on the CPU the flash lane is
  the kernel's plain version; the JAX package runs its plain lane).
* ``decode_step`` teacher-forced from an empty cache: logits at every step
  and the caches after the last (hymba past its reduced window of 16, so
  the rolling buffer wraps).
* ``prefill`` and then ``decode_step``: logits, and the caches, which are
  bf16 for attention in both packages.
* The continuous-batching engine against the JAX engine, in both prefill
  modes, for the hybrid, ssm, moe and audio families.

Tolerances: logits at rtol = atol = 2e-5 (float32, sums taken in another
order); after a bf16 cache 1e-4, and the bf16 caches within one bf16 ulp.
The xLSTM stack is the exception, with its own bound below.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCH_NAMES as JAX_ARCH_NAMES
from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import reduced_config as jax_reduced
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.models import (ARCH_NAMES, DecoderLM, EncDecLM, build_model,
                                get_config, reduced_config)
from repro_torch.serve import Request, ServeEngine
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
AFTER_BF16 = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
# The mLSTM divides its scan output by max(|normaliser|, 1) and rms-normalises
# each head: where a head's output is small (q . k near 0), the float32 ulps
# in which the two libraries' log, cumsum and einsum differ are scaled up by
# 1 / rms, several thousand at these weights (tests/test_torch_ssm.py holds
# the blocks themselves at 1e-5). 2.1e-4 is the largest logit gap seen.
XLSTM_TOL = dict(rtol=5e-4, atol=5e-4)
MARGIN_FLOOR = 1e-4
B = 2


class Pair(NamedTuple):
    """One architecture in both packages, with the same weights; the JAX
    package's entry points jit-compiled (one XLA program each)."""
    jmodel: object
    jparams: dict
    model: object
    params: object
    jforward: object
    jprefill: object
    jstep: object


@pytest.fixture(scope="module")
def pairs():
    """arch -> ``Pair``, built once per architecture."""
    cache = {}

    def get(name):
        if name not in cache:
            jmodel = jax_build(jax_reduced(jax_get_config(name)))
            jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
            model = build_model(reduced_config(get_config(name)))
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
            cache[name] = Pair(jmodel, jparams, model, params,
                               jax.jit(jmodel.forward),
                               jax.jit(jmodel.prefill),
                               jax.jit(jmodel.decode_step))
        return cache[name]

    return get


def _tol(name, tol=TOL):
    return XLSTM_TOL if name == "xlstm-125m" else tol


def _tokens(b, s, seed, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _frames(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree, path="cache"):
    """(path, leaf) of a cache: NamedTuples, dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _jax_layer_cache(jmodel, jcache, i):
    """Layer i of the JAX package's cache: stacked on a layers axis for a
    homogeneous stack, a list otherwise."""
    if jmodel.homogeneous:
        return jax.tree.map(lambda a: a[i], jcache)
    return jcache[i]


def _close_caches(model, jmodel, cache, jcache, tol):
    if isinstance(model, EncDecLM):
        pairs = [(cache.self_kv, jcache.self_kv),
                 (cache.cross_kv, jcache.cross_kv),
                 (cache.length, jcache.length)]
    else:
        pairs = [(cache[i], _jax_layer_cache(jmodel, jcache, i))
                 for i in range(model.cfg.n_layers)]
    for got, want in pairs:
        g, w = list(_leaves(got)), list(_leaves(want))
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, a), (_, b) in zip(g, w):
            assert a.dtype == bridge._tensor(np.asarray(b)).dtype, path
            leaf_tol = BF16_ULP if a.dtype == torch.bfloat16 else tol
            np.testing.assert_allclose(
                a.float().numpy(), np.asarray(b, np.float32), **leaf_tol,
                err_msg=path)


def test_the_registry_is_the_reference_registry():
    assert ARCH_NAMES == JAX_ARCH_NAMES


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_is_the_reference_config(name):
    cfg, want = get_config(name), jax_get_config(name)
    for field in dataclasses.fields(cfg):
        if field.name != "dtype":
            assert getattr(cfg, field.name) == getattr(want, field.name), \
                field.name
    assert cfg.dtype == torch.bfloat16
    red, jred = reduced_config(cfg), jax_reduced(want)
    for field in dataclasses.fields(red):
        if field.name != "dtype":
            assert getattr(red, field.name) == getattr(jred, field.name)
    assert red.sub_quadratic == jred.sub_quadratic
    assert red.ssm_config() == tuple(jred.ssm_config())
    assert red.xlstm_config() == tuple(jred.xlstm_config())
    assert red.moe_config() == tuple(jred.moe_config())


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_parameter_counts_match_the_reference(name):
    for cfg, jcfg in ((get_config(name), jax_get_config(name)),
                      (reduced_config(get_config(name)),
                       jax_reduced(jax_get_config(name)))):
        model, jmodel = build_model(cfg), jax_build(jcfg)
        assert isinstance(model, EncDecLM if cfg.family == "audio"
                          else DecoderLM)
        assert model.n_params() == jmodel.n_params()
        assert model.n_active_params() == jmodel.n_active_params()


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward(pairs, name, flash):
    pair = pairs(name)
    model = pair.model
    if flash:
        model = build_model(dataclasses.replace(model.cfg,
                                                use_flash_kernel=True))
    tok = _tokens(B, 16, seed=1)
    frames = {}
    if model.cfg.family == "audio":
        frames = {"frames": _frames(model.cfg, 1)}
    got = model.forward(pair.params, torch.from_numpy(tok),
                        **{k: torch.from_numpy(v) for k, v in frames.items()})
    want = pair.jforward(pair.jparams, jnp.asarray(tok),
                         **{k: jnp.asarray(v) for k, v in frames.items()})
    assert got.shape == (B, 16, 256) and got.dtype == torch.float32
    _close(got, want, _tol(name))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_step_teacher_forced(pairs, name):
    """From an empty float32 cache, one token at a time. The decoder-only
    families end on the forward's last logits; whisper decodes against the
    zero cross K/V of an empty cache, as the reference does."""
    jmodel, jparams, model, params, _, _, jstep = pairs(name)
    s = 20 if model.cfg.window else 12      # hymba: past its window of 16
    tok = _tokens(B, s, seed=2)
    jc = jmodel.init_cache(B, s, dtype=jnp.float32)
    tc = model.init_cache(B, s, dtype=torch.float32, device="cpu")
    for t in range(s):
        jl, jc = jstep(jparams, jnp.asarray(tok[:, t]), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok[:, t]), tc)
        assert tl.dtype == torch.float32 and tl.shape == (B, 256)
        _close(tl, jl, _tol(name))
    _close_caches(model, jmodel, tc, jc, _tol(name))
    if model.cfg.family != "audio":
        _close(tl, model.forward(params, torch.from_numpy(tok))[:, -1],
               _tol(name))


def _carry(model, jmodel, jcache):
    """The JAX package's cache as the port's, through the bridge."""
    def to(tree):
        return bridge.from_reference(jax.tree.map(np.asarray, tree))

    if isinstance(model, EncDecLM):
        return EncDecLM.Cache(self_kv=[to(kv) for kv in jcache.self_kv],
                              cross_kv=[to(tuple(kv))
                                        for kv in jcache.cross_kv],
                              length=to(jcache.length))
    layers = [_jax_layer_cache(jmodel, jcache, i)
              for i in range(model.cfg.n_layers)]
    return [{k: to(v) for k, v in c.items()} if isinstance(c, dict)
            else to(c) for c in layers]


def _pad_self_kv(cache, n, zeros, cat):
    """whisper's prompt-sized self-attention caches with n empty slots
    appended, as tests/test_models.py pads them for further decoding."""
    def pad(kv):
        z = zeros((B, n, *kv.k.shape[2:]), kv.k.dtype)
        return kv._replace(k=cat([kv.k, z], 1), v=cat([kv.v, z], 1))

    return cache._replace(self_kv=[pad(kv) for kv in cache.self_kv])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_then_decode(pairs, name):
    """prefill's logits (also against the port's forward) and caches; then
    decode steps from the JAX package's prefilled cache carried across, so
    that a bf16 cache entry that rounded the other way in the port (one
    bf16 ulp) does not stand for a difference in the decode. hymba's
    prompt of 20 passes its window of 16: the cache is a wrapped rolling
    buffer. whisper's caches are padded by the caller."""
    jmodel, jparams, model, params, _, jprefill, jstep = pairs(name)
    p, s = 20, 24
    tok = _tokens(B, s, seed=3)
    frames = {}
    if model.cfg.family == "audio":
        frames = {"frames": _frames(model.cfg, 3)}
    jl, jc = jprefill(jparams, jnp.asarray(tok[:, :p]),
                      **{k: jnp.asarray(v) for k, v in frames.items()})
    tframes = {k: torch.from_numpy(v) for k, v in frames.items()}
    tl, tc = model.prefill(params, torch.from_numpy(tok[:, :p]), **tframes)
    _close(tl, jl, _tol(name))
    _close(tl, model.forward(params, torch.from_numpy(tok[:, :p]),
                             **tframes)[:, -1], _tol(name))
    _close_caches(model, jmodel, tc, jc, _tol(name))
    if frames:
        jc = _pad_self_kv(jc, s - p, jnp.zeros, jnp.concatenate)
    tc = _carry(model, jmodel, jc)
    for t in range(p, s):
        jl, jc = jstep(jparams, jnp.asarray(tok[:, t]), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok[:, t]), tc)
        _close(tl, jl, _tol(name, AFTER_BF16))
    _close_caches(model, jmodel, tc, jc, _tol(name, AFTER_BF16))


class _MarginEngine(ServeEngine):
    """The port's engine, recording each step's smallest top-2 margin."""

    def _greedy(self, logits):
        top = torch.topk(logits, 2, dim=-1).values
        self.margins.append(float((top[:, 0] - top[:, 1]).min()))
        return super()._greedy(logits)


def _serve(eng, req_cls, prompts):
    """Each prompt's generated tokens, the engine drained."""
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    return [tuple(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_tokens(pairs):
    """arch -> the JAX engine's tokens for ``ENGINE_PROMPTS``, served once
    (its fused and token-by-token prefills give equal tokens, which
    tests/test_serve_engine.py holds)."""
    cache = {}

    def get(name):
        if name not in cache:
            jmodel, jparams = pairs(name)[:2]
            cache[name] = _serve(JaxEngine(jmodel, jparams, max_batch=3,
                                           max_seq=32, prefill_mode="loop"),
                                 JaxRequest, ENGINE_PROMPTS)
        return cache[name]

    return get


ENGINE_PROMPTS = [p.astype(np.int32) for p in
                  np.random.default_rng(4).integers(2, 256, (5, 5))]


@pytest.mark.parametrize("mode", ["fused", "loop"])
@pytest.mark.parametrize("name", ["hymba-1.5b", "xlstm-125m",
                                  "moonshot-v1-16b-a3b", "whisper-small"])
def test_engine_tokens_match_the_reference_engine(pairs, jax_tokens, name,
                                                  mode):
    """The port's engine in either prefill mode gives the JAX engine's
    tokens, every greedy choice clear of a float32 tie. The engines do not
    reset a slot's recurrent state for a new request, and whisper decodes
    against the zero cross K/V of ``init_cache``: both packages alike."""
    model, params = pairs(name)[2:4]
    teng = _MarginEngine(model, params, max_batch=3, max_seq=32,
                         prefill_mode=mode)
    teng.margins = []
    assert _serve(teng, Request, ENGINE_PROMPTS) == jax_tokens(name)
    assert min(teng.margins) > MARGIN_FLOOR
