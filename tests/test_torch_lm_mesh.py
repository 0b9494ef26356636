"""The LM scaffold over a device mesh, on the CPU: the port's sharding rules,
its sharded KV cache and decode, expert-parallel MoE and the serving engine
over ``REPRO_TORCH_DEVICE_COUNT`` logical CPU devices, against the JAX
package and against the port's unsharded path.

* Specs entry for entry: ``param_specs`` (with and without
  ``drop_axes=("embed",)``) and ``cache_shardings`` of all ten
  architectures at their published sizes on (1, 1), (2, 4), (1, 8),
  (8, 1), (16, 16) and (2, 16, 16), the JAX package's resolved on
  ``jax.sharding.AbstractMesh`` (no devices). The JAX package stacks a
  homogeneous stack on a leading ``layers`` axis, which resolves to no
  mesh axis; its specs are compared with that entry taken off.
* ``put`` / ``gather`` round trips bit for bit (a dim that does not divide
  stays whole), and each device's block is a tensor of its own.
* The sharded ``_cache_update`` equals the plain write at slots 0, 7, 13
  and 31, and writes nothing at S and S + 3, where the plain write clamps
  onto the last entry; both against the JAX package's own ``shard_map``
  write on 8 XLA devices.
* ``attention_decode(mesh=)``, both lanes (the kernel lane's plain version
  here), against the unsharded port and the JAX function, hymba's rolling
  buffer included past its window.
* Every family's ``prefill`` and ``decode_step`` over (1, 4) and (2, 2)
  against the unsharded port.
* ``moe_local`` against the JAX package's on 8 XLA devices at capacity
  factor 8 and 1.25 (where its drops differ from ``moe``'s).
* The engine over (1, 4) and (2, 2): tokens equal to the unsharded engine
  and to the JAX engine; ``launch.serve`` under the variable.

The JAX package's multi-device references come from one subprocess with 8
XLA CPU devices (``_JAX_REFERENCE``, ~12 s), as tests/test_distribution.py
runs them.

Tolerances: float32 outputs at rtol = atol = 1e-5 against the unsharded
port (a sharded decode sums its shards' partial softmaxes in another
order), 2e-5 against the JAX package (the families' bound); cache writes
and round trips bit for bit.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import reduced_config as jax_reduced
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.device import DEVICE_COUNT_VAR, Mesh
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import (ARCH_NAMES, build_model, get_config,
                                reduced_config)
from repro_torch.models import layers as TL
from repro_torch.models import moe as tmoe
from repro_torch.models.spec import (NamedSharding, PartitionSpec, Sharded,
                                     batch_ranks, gather, logical_constraint,
                                     map_leaves, place_tree, put,
                                     tree_leaves)
from repro_torch.serve import Request, ServeEngine
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (1, 8): ("data", "model"), (8, 1): ("data", "model"),
          (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
CACHE_SLOTS = (0, 7, 13, 31, 32, 35)

_JAX_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models.layers import _cache_update
from repro.models.moe import MoEConfig, moe_local, moe_params
from repro.models.spec import init_params

out = {}
mesh = jax.make_mesh((2, 4), ('data', 'model'))
for cf in (8.0, 1.25):
    cfg = MoEConfig(d_model=32, d_ff=64, n_experts=8, top_k=2,
                    capacity_factor=cf)
    params = init_params(jax.random.PRNGKey(0), moe_params(cfg))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))
    xs = jax.device_put(x, NamedSharding(mesh, P('data', None, None)))
    got = jax.jit(lambda p, xx: moe_local(p, cfg, xx, mesh))(params, xs)
    for k, v in params.items():
        out[f'moe{cf}_{k}'] = np.asarray(v)
    out[f'moe{cf}_x'] = np.asarray(x)
    out[f'moe{cf}_y'] = np.asarray(got.y)
    out[f'moe{cf}_aux'] = np.asarray(got.aux_loss)
    out[f'moe{cf}_drop'] = np.asarray(got.dropped_frac)
cache = jax.random.normal(jax.random.PRNGKey(0), (4, 32, 2, 8))
new = jax.random.normal(jax.random.PRNGKey(1), (4, 1, 2, 8))
out['cache'], out['new'] = np.asarray(cache), np.asarray(new)
cs = jax.device_put(cache, NamedSharding(mesh, P('data', 'model', None, None)))
write = jax.jit(lambda c, n, s: _cache_update(c, n, s, mesh))
for slot in %s:
    out[f'cache_{slot}'] = np.asarray(write(cs, new, jnp.int32(slot)))
np.savez(sys.argv[1], **out)
""" % (CACHE_SLOTS,)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's multi-device outputs (a subprocess, 8 devices)."""
    path = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _JAX_REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def logical(monkeypatch):
    """``n`` logical CPU devices for the rest of the test."""
    def set_count(n):
        monkeypatch.setenv(DEVICE_COUNT_VAR, str(n))
    return set_count


def _mesh(shape, names=None):
    names = names or SHAPES.get(tuple(shape), ("data", "model"))
    return Mesh([CPU] * int(np.prod(shape)), names, shape)


def _whole(tree):
    """A tree with every ``Sharded`` leaf gathered on the CPU."""
    return map_leaves(lambda x: gather(x, CPU), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(gather(got, CPU).detach().float()),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# meshes and specs
# ---------------------------------------------------------------------------

def test_mesh_is_n_dimensional_and_cheap():
    mesh = _mesh((2, 16, 16))
    assert mesh.size == 512 and mesh.axis_size("model") == 16
    assert mesh.axis_size("stage") == 1
    assert mesh.coords(mesh.index(pod=1, data=3, model=5)) == {
        "pod": 1, "data": 3, "model": 5}
    # a 1-d mesh keeps its form; two names without a shape put every
    # device on the last axis
    assert Mesh([CPU] * 4, ("slots",)).shape == (4,)
    assert Mesh([CPU] * 2, ("a", "b")).shape == (1, 2)
    with pytest.raises(ValueError, match="needs 8 devices"):
        Mesh([CPU] * 4, ("data", "model"), (2, 4))


def test_host_and_production_meshes(logical, monkeypatch):
    monkeypatch.delenv(DEVICE_COUNT_VAR, raising=False)
    assert make_host_mesh("cpu").shape == (1, 1)
    with pytest.raises(ValueError, match=DEVICE_COUNT_VAR):
        make_production_mesh(device="cpu")
    logical(4)
    host = make_host_mesh("cpu")
    assert host.axis_names == ("data", "model") and host.shape == (1, 4)
    logical(512)
    assert make_production_mesh(device="cpu").shape == (16, 16)
    multi = make_production_mesh(multi_pod=True, device="cpu")
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == (2, 16, 16)


def _jax_specs(tree, stacked_layers):
    """A JAX spec tree as the port's: ``PartitionSpec`` leaves, the layers
    of a stacked stack a list with the leading entry taken off."""
    def conv(spec, unstack):
        entries = tuple(spec)[1:] if unstack else tuple(spec)
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def walk(node, unstack=False):
        if isinstance(node, jax.sharding.PartitionSpec):
            return conv(node, unstack)
        if isinstance(node, jax.sharding.NamedSharding):
            return conv(node.spec, unstack)
        if isinstance(node, dict):
            return {k: walk(v, unstack) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, unstack) for v in node]
        items = [walk(v, unstack) for v in node]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(
            items)

    if stacked_layers and isinstance(tree, dict) and "layers" in tree:
        one = walk(tree["layers"], True)
        return {**{k: walk(v) for k, v in tree.items() if k != "layers"},
                "layers": [one] * stacked_layers}
    return walk(tree)


def _specs(tree):
    return [x.spec if isinstance(x, NamedSharding) else x
            for x in tree_leaves(tree)]


def _stacked(jmodel, n_layers):
    return n_layers if getattr(jmodel, "homogeneous", False) else 0


def _jax_cache_specs(jmodel, jmesh, n_layers):
    """The JAX package's cache shardings as a list a layer, as the port's."""
    cs = jmodel.cache_shardings(jmesh, 4, 256)
    if not hasattr(jmodel, "homogeneous"):
        return _jax_specs(cs, 0)
    if jmodel.homogeneous:
        one = _jax_specs({"layers": cs}, 1)["layers"][0]
        return [one] * n_layers
    return _jax_specs(cs, 0)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_the_reference(arch, shape):
    jmodel = jax_build(jax_get_config(arch))
    model = build_model(get_config(arch))
    jmesh = AbstractMesh(shape, SHAPES[shape])
    mesh = _mesh(shape)
    n = model.cfg.n_layers
    stacked = _stacked(jmodel, n)
    assert _specs(model.param_specs(mesh)) == _specs(
        _jax_specs(jmodel.param_specs(jmesh), stacked))
    assert _specs(model.param_shardings(mesh, drop_axes=("embed",))) == \
        _specs(_jax_specs(jmodel.param_shardings(jmesh, drop_axes=("embed",)),
                          stacked))
    assert _specs(model.cache_shardings(mesh, 4, 256)) == _specs(
        _jax_cache_specs(jmodel, jmesh, n))


def test_resolve_spec_single_use_and_divisibility():
    """llama3.2-1b on (2, 16, 16): kv_heads 8 does not divide model 16, so
    wk replicates over it while wq shards; embed takes (pod, data)."""
    specs = build_model(get_config("llama3.2-1b")).param_specs(
        _mesh((2, 16, 16)))
    attn = specs["layers"][0]["attn"]
    assert attn["wq"] == PartitionSpec(("pod", "data"), "model")
    assert attn["wk"] == PartitionSpec(("pod", "data"))


# ---------------------------------------------------------------------------
# put, gather, logical_constraint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    PartitionSpec("data", "model"), PartitionSpec(None, None, ("data",
                                                               "model")),
    PartitionSpec(), PartitionSpec("model", None, "data"),
    PartitionSpec(None, "model")])
def test_put_gather_round_trip(spec):
    mesh = _mesh((2, 4))
    x = torch.randn(4, 6, 8, generator=torch.Generator().manual_seed(0))
    s = put(x, NamedSharding(mesh, spec))
    assert isinstance(s, Sharded) and len(s.blocks) == 8
    assert torch.equal(s.gather(), x)
    assert torch.equal(s.gather(rows=(1, 3)), x[1:3])
    # each device holds its own tensor; a dim of 6 over model 4 stays whole
    assert len({b.data_ptr() for b in s.blocks}) == 8
    for i, b in enumerate(s.blocks):
        assert b.shape == tuple(hi - lo for lo, hi in s.ranges(i))
        if "model" in tuple(spec)[1:2]:
            assert b.shape[1] == 6


def test_put_on_one_device_and_scalars_are_plain():
    x = torch.arange(6.0)
    assert put(x, NamedSharding(_mesh((1, 1)), PartitionSpec("data"))) is x
    s = put(torch.tensor(3), NamedSharding(_mesh((2, 4)), PartitionSpec()))
    assert int(s.gather()) == 3 and len(s.unique()) == 1


def test_logical_constraint():
    x = torch.randn(4, 3, 8)
    assert logical_constraint(x, ("batch", "seq", None), None) is x
    assert logical_constraint(x, ("batch", "seq", None), _mesh((1, 1))) is x
    s = logical_constraint(x, ("batch", "seq", None), _mesh((2, 4)))
    assert s.sharding.spec == PartitionSpec("data")
    assert torch.equal(s.gather(), x)
    chunks = logical_constraint([x[:2], x[2:]], ("batch", "seq", None),
                                _mesh((2, 4)))
    assert [c.shape[0] for c in chunks] == [2, 2]
    ranks = batch_ranks(_mesh((2, 4)), 4)
    assert [(r.lo, r.hi, r.coords) for r in ranks] == [
        (0, 2, {"data": 0}), (2, 4, {"data": 1})]
    assert len(batch_ranks(_mesh((2, 4)), 3)) == 1


# ---------------------------------------------------------------------------
# the sharded KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot", CACHE_SLOTS)
def test_sharded_cache_update_matches_plain_and_reference(jax_ref, slot):
    mesh = _mesh((2, 4))
    cache = torch.from_numpy(jax_ref["cache"])
    new = torch.from_numpy(jax_ref["new"])
    sharded = put(cache, NamedSharding(mesh, PartitionSpec("data", "model")))
    TL._cache_update(sharded, new, torch.tensor(slot), mesh)
    got = sharded.gather().numpy()
    np.testing.assert_array_equal(got, jax_ref[f"cache_{slot}"])
    plain = TL._cache_update(cache.clone(), new, torch.tensor(slot))
    want = jax.lax.dynamic_update_slice(jnp.asarray(jax_ref["cache"]),
                                        jnp.asarray(jax_ref["new"]),
                                        (0, slot, 0, 0))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    if slot < cache.shape[1]:
        np.testing.assert_array_equal(got, plain.numpy())
    else:
        # past the end: the sharded write lands nowhere, the plain one
        # clamps onto the last entry (ROADMAP Queue C)
        np.testing.assert_array_equal(got, jax_ref["cache"])
        np.testing.assert_array_equal(plain[:, -1:].numpy(), jax_ref["new"])
    # a plain cache over the mesh follows the sharded rule in one piece
    one = TL._cache_update(cache.clone(), new, torch.tensor(slot), mesh)
    np.testing.assert_array_equal(one.numpy(), got)


def _attn_pair(window):
    """JAX and port attention params and config (d 64, 4 heads over 2 KV
    heads, Dh 16; hymba-like with a window)."""
    cfg = JL.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                        window=window)
    tcfg = TL.AttnConfig(*cfg)
    rng = np.random.default_rng(7)
    tree = {k: (rng.standard_normal(s) * 0.15).astype(np.float32)
            for k, s in (("wq", (64, 4, 16)), ("wk", (64, 2, 16)),
                         ("wv", (64, 2, 16)), ("wo", (4, 16, 64)))}
    return cfg, tcfg, {k: jnp.asarray(v) for k, v in tree.items()}, {
        k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("window,size,steps", [(0, 32, 12), (16, 16, 21)])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_attention_decode_over_a_mesh(shape, window, size, steps,
                                      use_kernel):
    """Teacher-forced decode over a cache laid out as ("batch", "kv_seq",
    "kv_heads", None): against the unsharded port and the JAX function (a
    window of 16 in a 16-slot rolling buffer, 21 steps: past the window)."""
    mesh = _mesh(shape)
    cfg, tcfg, jp, tp = _attn_pair(window)
    b = 4
    xs = np.random.default_rng(3).standard_normal(
        (steps, b, 1, 64)).astype(np.float32)
    jcache = JL.init_kv_cache(b, size, cfg, jnp.float32)
    plain = TL.init_kv_cache(b, size, tcfg, torch.float32, device="cpu")
    spec = NamedSharding(mesh, PartitionSpec("data", "model"))
    sharded = TL.KVCache(*(put(t, spec) for t in plain[:2]), plain.length)
    for t in range(steps):
        x = torch.from_numpy(xs[t])
        want, jcache = JL.attention_decode(jp, cfg, jnp.asarray(xs[t]),
                                           jcache)
        ref, plain = TL.attention_decode(tp, tcfg, x, plain,
                                         use_kernel=use_kernel)
        parts = []
        for r in batch_ranks(mesh, b):
            out, new = TL.attention_decode(
                tp, tcfg, x[r.lo:r.hi], sharded, mesh=mesh, row0=r.lo,
                use_kernel=use_kernel)
            parts.append(out)
        sharded = sharded._replace(length=new.length)
        got = torch.cat(parts)
        _close(got, ref.numpy())
        _close(got, np.asarray(want), JAX_TOL)
    assert isinstance(sharded.k, Sharded)
    np.testing.assert_array_equal(sharded.k.gather().numpy(),
                                  plain.k.numpy())


@pytest.mark.parametrize("window,size,steps", [(0, 32, 12), (16, 16, 21)])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_attention_decode_over_a_mesh_in_bf16(shape, window, size, steps):
    """The einsum lane over a bf16 cache sharded along its sequence rounds
    the normalised p to bf16 before P.V, as the unsharded lane and the JAX
    package's ``attention_decode`` do (before, it kept each shard's p in
    float32 unnormalised: 3e-3 rms apart a layer, 1.7e-2 at llama3.2-1b's
    logits on the card). Bound: one bf16 ulp of the output's largest entry
    (2^-8 of it) against the unsharded lane, two against the JAX function
    (bf16 products and sums in XLA's order)."""
    mesh = _mesh(shape)
    cfg, tcfg, jp, tp = _attn_pair(window)
    b = 4
    bf = torch.bfloat16
    xs = np.random.default_rng(5).standard_normal(
        (steps, b, 1, 64)).astype(np.float32)
    jcache = JL.init_kv_cache(b, size, cfg, jnp.bfloat16)
    plain = TL.init_kv_cache(b, size, tcfg, bf, device="cpu")
    spec = NamedSharding(mesh, PartitionSpec("data", "model"))
    sharded = TL.KVCache(*(put(t, spec) for t in plain[:2]), plain.length)
    jpb = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
    tpb = {k: v.to(bf) for k, v in tp.items()}
    for t in range(steps):
        x = torch.from_numpy(xs[t]).to(bf)
        want, jcache = JL.attention_decode(
            jpb, cfg, jnp.asarray(xs[t]).astype(jnp.bfloat16), jcache)
        ref, plain = TL.attention_decode(tpb, tcfg, x, plain)
        parts = []
        for r in batch_ranks(mesh, b):
            out, new = TL.attention_decode(tpb, tcfg, x[r.lo:r.hi], sharded,
                                           mesh=mesh, row0=r.lo)
            parts.append(out)
        sharded = sharded._replace(length=new.length)
        got = torch.cat(parts).float()
        ref = ref.float()
        ulp = 2.0 ** -8 * float(ref.abs().max())
        assert float((got - ref).abs().max()) <= ulp
        jwant = np.asarray(want.astype(jnp.float32))
        assert float(np.abs(got.numpy() - jwant).max()) <= 2 * ulp
    np.testing.assert_array_equal(sharded.k.gather().float().numpy(),
                                  plain.k.float().numpy())


# ---------------------------------------------------------------------------
# every family over a mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def families():
    out = {}
    for arch in ARCH_NAMES:
        model = build_model(reduced_config(get_config(arch)))
        out[arch] = (model, model.init(torch.Generator().manual_seed(0),
                                       device="cpu"))
    return out


def _frames(model, b):
    if model.cfg.family != "audio":
        return {}
    return {"frames": torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b, model.cfg.enc_seq, model.cfg.d_model)).astype(np.float32))}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_family_prefill_and_decode_over_a_mesh(families, arch):
    """prefill, forward and six decode steps over (1, 4) and (2, 2) equal
    the unsharded port (hymba's 16-slot window wraps at step 16 of a
    24-slot decode cache; its prefill cache is sized to the prompt)."""
    model, params = families[arch]
    b, s = 4, 8
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (b, s)))
    kw = _frames(model, b)
    logits0, cache0 = model.prefill(params, tokens, **kw)
    fwd0 = model.forward(params, tokens, **kw)
    for shape in ((1, 4), (2, 2)):
        mesh = _mesh(shape)
        logits1, cache1 = model.prefill(params, tokens, mesh=mesh, **kw)
        _close(logits1, logits0.numpy())
        _close(model.forward(params, tokens, mesh=mesh, **kw), fwd0.numpy())
        for got, want in zip(tree_leaves(_whole(cache1)),
                             tree_leaves(cache0)):
            _close(got, want.float().numpy())
        plain = model.init_cache(b, 24, torch.float32, device="cpu")
        sharded = place_tree(model.init_cache(b, 24, torch.float32,
                                              device="cpu"),
                             model.cache_shardings(mesh, b, 24,
                                                   torch.float32))
        assert any(isinstance(x, Sharded) for x in tree_leaves(sharded))
        for t in range(6):
            step = tokens[:, t]
            want, plain = model.decode_step(params, step, plain)
            got, sharded = model.decode_step(params, step, sharded, mesh)
            _close(got, want.numpy())
        for got, want in zip(tree_leaves(_whole(sharded)),
                             tree_leaves(plain)):
            _close(got, want.float().numpy())


def test_a_mesh_of_one_device_is_the_unsharded_path(families):
    model, params = families["llama3.2-1b"]
    tokens = torch.arange(12).reshape(2, 6)
    one = _mesh((1, 1))
    assert torch.equal(model.forward(params, tokens, mesh=one),
                       model.forward(params, tokens))
    a, _ = model.prefill(params, tokens, mesh=one)
    assert torch.equal(a, model.prefill(params, tokens)[0])
    with pytest.raises(TypeError, match="device.Mesh"):
        model.decode_step(params, tokens[:, 0],
                          model.init_cache(2, 8, device="cpu"), object())


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_moe_local_matches_the_reference(jax_ref, cf):
    """Capacity from the local token count; aux and the dropped fraction
    the first data rank's, as the JAX package's shard_map returns them."""
    cfg = tmoe.MoEConfig(32, 64, 8, 2, cf)
    params = {k: torch.from_numpy(jax_ref[f"moe{cf}_{k}"])
              for k in ("router", "w_gate", "w_in", "w_out")}
    x = torch.from_numpy(jax_ref[f"moe{cf}_x"])
    mesh = _mesh((2, 4))
    got = tmoe.moe_local(params, cfg, x, mesh)
    _close(got.y, jax_ref[f"moe{cf}_y"])
    _close(got.aux_loss, jax_ref[f"moe{cf}_aux"], JAX_TOL)
    np.testing.assert_allclose(float(got.dropped_frac),
                               float(jax_ref[f"moe{cf}_drop"]), atol=1e-7)
    glob = tmoe.moe(params, cfg, x)
    if cf == 8.0:
        assert float(got.dropped_frac) == float(glob.dropped_frac) == 0.0
        _close(got.y, glob.y.numpy())
    else:
        assert float(got.dropped_frac) != float(glob.dropped_frac)
    # the experts stored per their spec give the same output
    sharded = {k: put(v, NamedSharding(mesh, PartitionSpec(
        *(("model", "data") if k != "router" else ("data", "model")))))
        for k, v in params.items()}
    assert torch.equal(tmoe.moe_local(sharded, cfg, x, mesh).y, got.y)


def test_moe_local_falls_back_where_the_reference_does():
    cfg = tmoe.MoEConfig(32, 64, 6, 2, 8.0)
    g = torch.Generator().manual_seed(2)
    params = {"router": torch.randn(32, 6, generator=g) * 0.1,
              "w_gate": torch.randn(6, 32, 64, generator=g) * 0.2,
              "w_in": torch.randn(6, 32, 64, generator=g) * 0.2,
              "w_out": torch.randn(6, 64, 32, generator=g) * 0.1}
    x = torch.randn(2, 5, 32, generator=g)
    want = tmoe.moe(params, cfg, x)
    for shape in ((2, 1), (1, 4)):          # no model axis; 6 over 4
        got = tmoe.moe_local(params, cfg, x, _mesh(shape))
        assert torch.equal(got.y, want.y)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_pair():
    jmodel = jax_build(jax_reduced(jax_get_config("llama3.2-1b")))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(get_config("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    bridge.load_lm_params(params, jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, model, params


def _serve(engine, req_cls, prompts):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [tuple(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_engine_over_a_mesh_matches_both_engines(llama_pair, shape):
    jmodel, jparams, model, params = llama_pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, 256, n).astype(np.int32)
               for n in (5, 1, 7, 3, 6, 9)]
    mesh = _mesh(shape)
    sharded = ServeEngine(model, params, max_batch=4, max_seq=48, mesh=mesh)
    assert all(isinstance(kv.k, Sharded) for kv in sharded.cache)
    assert sharded.cache[0].k.sharding.spec == PartitionSpec(
        "data", "model")
    got = _serve(sharded, Request, prompts)
    assert got == _serve(ServeEngine(model, params, max_batch=4,
                                     max_seq=48), Request, prompts)
    assert got == _serve(JaxEngine(jmodel, jparams, max_batch=4, max_seq=48),
                         JaxRequest, prompts)


def test_launch_serve_over_logical_devices(logical, capsys):
    logical(4)
    launcher.main(["--reduced", "--device", "cpu", "--requests", "3",
                   "--max-new", "4", "--max-seq", "32"])
    assert capsys.readouterr().out.startswith(
        "[serve] 3/3 requests, 12 tokens")
    args = launcher.parse_args(["--reduced", "--device", "cpu",
                                "--requests", "3", "--max-new", "4",
                                "--max-seq", "32"])
    cfg, model, params = launcher.build(args)
    reqs, _, _ = launcher.serve(model, params, args, cfg.vocab)
    logical(1)
    plain, _, _ = launcher.serve(model, params, args, cfg.vocab)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in plain]
