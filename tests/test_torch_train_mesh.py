"""Training over a device mesh, on the CPU: the train state's and the
batch's shardings, the sharded train step, the GPipe pipeline, and elastic
restores, over ``REPRO_TORCH_DEVICE_COUNT`` logical CPU devices, against
the JAX package and the port's unsharded path.

* ``state_shardings``, ``batch_shardings`` and ``abstract_train_state`` of
  all ten architectures at their published sizes on (1, 1), (2, 4),
  (1, 8), (8, 1), (16, 16) and (2, 16, 16), entry for entry with the JAX
  package's on ``jax.sharding.AbstractMesh`` (its stacked layers axis taken
  off, as tests/test_torch_lm_mesh.py does).
* The train step on (2, 4), microbatches 1 and 2, compression off and on:
  the loss within the JAX package's own sharded-against-unsharded bound,
  2e-4 (tests/test_distribution.py), of the unsharded port's, and the whole
  state after three steps held to the JAX package's unsharded step at
  tests/test_torch_train_step.py's bounds (the same counted shares of
  entries beyond 1e-6, each within 2 lr a step). On a mesh of one device
  the step is the unsharded step bit for bit.
* The pipeline at tests/test_pipeline.py's shapes (4 stages x 2 data
  ranks, 8 layers, 6 microbatches): forward and gradients against the JAX
  package's ``sequential_reference`` in this process and against its
  ``make_pipeline_forward`` on 8 XLA devices (a subprocess, ~10 s), at that
  test's bounds (forward 2e-5, gradients rtol 5e-4 / atol 5e-5).
* ``reshard_restore`` and ``reshard_in_memory`` onto (1, 8), (8, 1) and
  (2, 4) bit for bit; ``restore(shardings=)`` of a train state the JAX
  package wrote (xlstm-125m, whose layer list both packages keep alike).
* ``launch.train`` under the variable, through an injected failure.
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

from repro.checkpoint import checkpointer as jax_checkpointer
from repro.data.pipeline import PipelineConfig, make_batch
from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import reduced_config as jax_reduced
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import pipeline as JP
from repro.train import step as JS
from repro_torch import bridge
from repro_torch.checkpoint import checkpointer
from repro_torch.device import DEVICE_COUNT_VAR, Mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import (ARCH_NAMES, build_model, get_config,
                                reduced_config)
from repro_torch.models.spec import (NamedSharding, PartitionSpec, Sharded,
                                     gather, map_leaves, put, tree_leaves)
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.elastic import reshard_in_memory, reshard_restore
from repro_torch.train import pipeline as TP
from repro_torch.train.step import (TrainState, abstract_train_state,
                                    batch_shardings, init_train_state,
                                    make_train_step, state_shardings)
from test_torch_lm_mesh import SHAPES, _jax_specs, _mesh, _specs, _stacked
from test_torch_train_step import (EF_SHARE, OPT, OUTLIER_SHARE, STEPS,
                                   _outliers)
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
LOSS_RTOL = 2e-4                 # tests/test_distribution.py
FWD_TOL = dict(rtol=2e-5, atol=2e-5)        # tests/test_pipeline.py
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
PIPE = dict(S=4, DATA=2, L=8, D=16, MB=4, M=6, T=8)

_JAX_PIPELINE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.train.pipeline import make_pipeline_forward

S, DATA, L, D, MB, M, T = %(S)d, %(DATA)d, %(L)d, %(D)d, %(MB)d, %(M)d, %(T)d
mesh = jax.make_mesh((S, DATA), ('stage', 'data'))
params = {
    'w': jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.2,
    'b': jax.random.normal(jax.random.PRNGKey(1), (L, D)) * 0.1,
}

def stage_fn(p, x):
    def layer(carry, wb):
        w, b = wb
        return jnp.tanh(carry @ w + b), None
    y, _ = jax.lax.scan(layer, x, (p['w'], p['b']))
    return y

x_mb = jax.random.normal(jax.random.PRNGKey(2), (M, MB, T, D))
pipe = make_pipeline_forward(stage_fn, S, mesh)
with jax.set_mesh(mesh):
    out = jax.jit(pipe)(params, x_mb)
    g = jax.grad(lambda p: jnp.sum(pipe(p, x_mb) ** 2))(params)
np.savez(sys.argv[1], w=np.asarray(params['w']), b=np.asarray(params['b']),
         x=np.asarray(x_mb), out=np.asarray(out), gw=np.asarray(g['w']),
         gb=np.asarray(g['b']))
""" % PIPE


@pytest.fixture
def logical(monkeypatch):
    def set_count(n):
        monkeypatch.setenv(DEVICE_COUNT_VAR, str(n))
    return set_count


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def _jax_state_specs(jmodel, jmesh, n_layers):
    """The JAX package's state shardings in the port's leaf order."""
    ss = JS.state_shardings(jmodel, jmesh, compress=True)
    stacked = _stacked(jmodel, n_layers)
    tree = lambda t: _specs(_jax_specs(t, stacked))
    return (tree(ss.params) + tree(ss.opt.m) + tree(ss.opt.v)
            + [PartitionSpec(*ss.opt.step.spec)] + tree(ss.ef.residual))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_state_and_batch_shardings_match_the_reference(arch, shape):
    jmodel = jax_build(jax_get_config(arch))
    model = build_model(get_config(arch))
    jmesh = AbstractMesh(shape, SHAPES[shape])
    mesh = _mesh(shape)
    got = _specs(state_shardings(model, mesh, compress=True))
    assert got == _jax_state_specs(jmodel, jmesh, model.cfg.n_layers)
    batch = {"tokens": jax.ShapeDtypeStruct((16, 128), jnp.int32),
             "frames": jax.ShapeDtypeStruct((16, 24, 64), jnp.float32),
             "odd": jax.ShapeDtypeStruct((3, 5), jnp.int32)}
    want = JS.batch_shardings(batch, jmesh)
    mine = batch_shardings(batch, mesh)
    assert {k: v.spec for k, v in mine.items()} == {
        k: PartitionSpec(*v.spec) for k, v in want.items()}
    # the abstract state: shapes and dtypes, nothing allocated
    abstract = abstract_train_state(model, compress=True)
    leaves = tree_leaves(abstract)
    assert all(x.device.type == "meta" for x in leaves)
    assert len(leaves) == len(got)
    n = len(tree_leaves(abstract.params))
    assert [tuple(x.shape) for x in leaves[:n]] == [
        tuple(p.shape) for p in tree_leaves(model.abstract_params())]


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,microbatches,compress", [
    ("llama3.2-1b", 1, False), ("llama3.2-1b", 1, True),
    ("llama3.2-1b", 2, False), ("llama3.2-1b", 2, True),
    ("dbrx-132b", 2, True), ("whisper-small", 1, False)])
def test_sharded_train_step_matches_reference(name, microbatches, compress):
    jmodel = jax_build(jax_reduced(jax_get_config(name)))
    model = build_model(reduced_config(get_config(name)))
    jstate = JS.init_train_state(jmodel, jax.random.PRNGKey(0),
                                 compress=compress)
    state_np = jax.tree.map(np.asarray, jstate)
    plain = bridge.load_train_state(model, state_np)
    mesh = _mesh((2, 4))
    sharded = reshard_in_memory(bridge.load_train_state(model, state_np),
                                model, mesh, compress=compress)
    assert all(isinstance(x, Sharded) for x in tree_leaves(sharded))
    jstep = jax.jit(JS.make_train_step(jmodel, JaxAdamWConfig(**OPT), None,
                                       microbatches=microbatches,
                                       compress=compress))
    kw = dict(microbatches=microbatches, compress=compress)
    step = make_train_step(model, AdamWConfig(**OPT), **kw)
    mesh_step = make_train_step(model, AdamWConfig(**OPT), mesh, **kw)
    audio = model.cfg.family == "audio"
    pipe = PipelineConfig(vocab=256, seq_len=16, global_batch=4,
                          frames_dim=64 if audio else 0,
                          enc_seq=24 if audio else 0)
    for s in range(STEPS):
        batch = make_batch(pipe, s)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jstate, jm = jstep(jstate, batch)
        plain, pm = step(plain, tb)
        sharded, sm = mesh_step(sharded, tb)
        np.testing.assert_allclose(float(sm["loss"]), float(pm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(sm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    assert all(isinstance(x, Sharded) for x in tree_leaves(sharded))
    whole = TrainState(*map_leaves(lambda x: gather(x, CPU), sharded))
    got = bridge.train_state_to_numpy(model, whole)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got.opt.step) == STEPS
    limit = 2 * OPT["lr"] * STEPS
    shares = {}
    for part, g, w in (("params", got.params, want.params),
                       ("m", got.opt.m, want.opt.m),
                       ("v", got.opt.v, want.opt.v),
                       ("ef", got.ef, want.ef)):
        if compress or part != "ef":
            n_bad, n = _outliers(g, w, limit)
            shares[part] = n_bad / n
    print(f"{name} microbatches={microbatches} compress={compress} over "
          "(2, 4): share beyond 1e-6 "
          + ", ".join(f"{k} {v:.2e}" for k, v in shares.items()))
    assert shares.pop("ef", 0.0) <= EF_SHARE
    assert max(shares.values()) <= OUTLIER_SHARE[compress], shares


def test_train_step_on_one_device_is_the_unsharded_step():
    model = build_model(reduced_config(get_config("llama3.2-1b")))
    states = [init_train_state(model, torch.Generator().manual_seed(0),
                               device="cpu") for _ in range(2)]
    steps = [make_train_step(model, AdamWConfig(**OPT)),
             make_train_step(model, AdamWConfig(**OPT), _mesh((1, 1)))]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        PipelineConfig(vocab=256, seq_len=16, global_batch=4), 0).items()}
    out = [step(state, batch) for step, state in zip(steps, states)]
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1]["loss"], out[1][1]["loss"])


def test_global_norm_and_adamw_over_shards():
    """The norm sums each distinct block once; an update block by block
    equals the whole update (a copy of a replicated block alike)."""
    mesh = _mesh((2, 4))
    g = torch.Generator().manual_seed(1)
    params = {"a": torch.randn(4, 8, generator=g),
              "b": torch.randn(6, generator=g)}
    grads = [torch.randn(4, 8, generator=g), torch.randn(6, generator=g)]
    specs = [PartitionSpec("data", "model"), PartitionSpec("model")]
    sp = {k: put(v.clone(), NamedSharding(mesh, s))
          for (k, v), s in zip(sorted(params.items()), specs)}
    sg = [put(x, NamedSharding(mesh, s)) for x, s in zip(grads, specs)]
    np.testing.assert_allclose(float(adamw.global_norm(sg)),
                               float(adamw.global_norm(grads)), rtol=1e-6)
    cfg = AdamWConfig(**OPT)
    plain_state = adamw.init_opt_state(params)
    shard_state = adamw.OptState(
        m=[put(torch.zeros_like(x), NamedSharding(mesh, s))
           for x, s in zip(grads, specs)],
        v=[put(torch.zeros_like(x), NamedSharding(mesh, s))
           for x, s in zip(grads, specs)],
        step=put(torch.zeros((), dtype=torch.int32),
                 NamedSharding(mesh, PartitionSpec())))
    _, st, _ = adamw.apply_updates(cfg, params, grads, plain_state)
    _, ss, _ = adamw.apply_updates(cfg, sp, sg, shard_state)
    for k in sorted(params):
        np.testing.assert_allclose(sp[k].gather().numpy(),
                                   params[k].numpy(), rtol=1e-6, atol=1e-7)
        blocks = sp[k].blocks
        for i in sp[k].unique():
            same = [j for j in range(len(blocks))
                    if sp[k].parts(j) == sp[k].parts(i)]
            assert all(torch.equal(blocks[j], blocks[i]) for j in same)
    assert int(gather(ss.step)) == int(st.step) == 1


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_pipe") / "pipe.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _JAX_PIPELINE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _stage_fn(p, x):
    for w, b in zip(p["w"], p["b"]):
        x = torch.tanh(x @ w + b)
    return x


def _jax_stage_fn(p, x):
    def layer(carry, wb):
        w, b = wb
        return jnp.tanh(carry @ w + b), None
    return jax.lax.scan(layer, x, (p["w"], p["b"]))[0]


def test_pipeline_forward_and_grads_match_the_reference(jax_pipeline):
    ref = jax_pipeline
    s = PIPE["S"]
    mesh = Mesh([CPU] * (s * PIPE["DATA"]), ("stage", "data"),
                (s, PIPE["DATA"]))
    params = {"w": torch.from_numpy(ref["w"]).requires_grad_(True),
              "b": torch.from_numpy(ref["b"]).requires_grad_(True)}
    x_mb = torch.from_numpy(ref["x"])
    pipe = TP.make_pipeline_forward(_stage_fn, s, mesh)
    out = pipe(params, x_mb)
    jparams = {"w": jnp.asarray(ref["w"]), "b": jnp.asarray(ref["b"])}
    want = JP.sequential_reference(_jax_stage_fn, s, jparams,
                                   jnp.asarray(ref["x"]))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    np.testing.assert_allclose(out.detach().numpy(), ref["out"], **FWD_TOL)
    seq = TP.sequential_reference(_stage_fn, s, params, x_mb)
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    gw, gb = torch.autograd.grad(torch.sum(out ** 2),
                                 [params["w"], params["b"]])
    jg = jax.grad(lambda p: jnp.sum(JP.sequential_reference(
        _jax_stage_fn, s, p, jnp.asarray(ref["x"])) ** 2))(jparams)
    for got, w_seq, w_pipe in ((gw, jg["w"], ref["gw"]),
                               (gb, jg["b"], ref["gb"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_seq),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got.numpy(), w_pipe, **GRAD_TOL)


def test_pipeline_refuses_a_mismatched_mesh():
    mesh = Mesh([CPU] * 4, ("stage", "data"), (2, 2))
    with pytest.raises(ValueError, match="stage axis"):
        TP.make_pipeline_forward(_stage_fn, 4, mesh)
    pipe = TP.make_pipeline_forward(_stage_fn, 2, mesh)
    with pytest.raises(ValueError, match="do not divide"):
        pipe({"w": torch.zeros(2, 3, 3), "b": torch.zeros(2, 3)},
             torch.zeros(2, 3, 1, 3))


# ---------------------------------------------------------------------------
# elastic restores
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_state(tmp_path_factory):
    """A reduced llama train state after one step on (2, 4), saved."""
    model = build_model(reduced_config(get_config("llama3.2-1b")))
    mesh = _mesh((2, 4))
    state = reshard_in_memory(
        init_train_state(model, torch.Generator().manual_seed(0),
                         compress=True, device="cpu"),
        model, mesh, compress=True)
    step = make_train_step(model, AdamWConfig(**OPT), mesh, compress=True)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        PipelineConfig(vocab=256, seq_len=16, global_batch=4), 0).items()}
    state, _ = step(state, batch)
    path = str(tmp_path_factory.mktemp("elastic"))
    checkpointer.save(path, 7, state)
    return model, state, path


@pytest.mark.parametrize("shape", [(1, 8), (8, 1), (2, 4)])
def test_reshard_restore_and_in_memory(saved_state, shape):
    model, state, path = saved_state
    mesh = _mesh(shape)
    restored, step = reshard_restore(model, path, mesh, compress=True)
    assert step == 7
    moved = reshard_in_memory(state, model, mesh, compress=True)
    specs = _specs(state_shardings(model, mesh, compress=True))
    for a, b, c, spec in zip(tree_leaves(restored), tree_leaves(moved),
                             tree_leaves(state), specs):
        assert torch.equal(gather(a, CPU), gather(c, CPU))
        assert torch.equal(gather(b, CPU), gather(c, CPU))
        for x in (a, b):
            if isinstance(x, Sharded):
                assert x.sharding.spec == spec and x.sharding.mesh == mesh


def test_restore_shardings_of_a_reference_checkpoint(tmp_path):
    """A train state the JAX package saved, laid out over (2, 4) by the
    port; xlstm-125m keeps its layers as a list in both packages."""
    jmodel = jax_build(jax_reduced(jax_get_config("xlstm-125m")))
    jstate = JS.init_train_state(jmodel, jax.random.PRNGKey(0))
    jax_checkpointer.save(str(tmp_path), 3, jstate)
    model = build_model(reduced_config(get_config("xlstm-125m")))
    restored, step = reshard_restore(model, str(tmp_path), _mesh((2, 4)))
    assert step == 3
    want = bridge.load_train_state(model, jax.tree.map(np.asarray, jstate))
    for got, w in zip(tree_leaves(restored), tree_leaves(want)):
        assert isinstance(got, Sharded)
        assert torch.equal(got.gather(), w.detach())


def test_launch_train_over_logical_devices(logical, tmp_path, capsys):
    logical(4)
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "6",
                       "--fail-at", "3", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path), "--batch", "4", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "restart #1: injected node failure at step 3" in out
    assert "resumed from step 2" in out and "[train] done at step 6" in out
    assert checkpointer.latest_step(str(tmp_path)) == 6
    args = launch_train.parse_args(["--reduced", "--device", "cpu"])
    _, _, mesh, _, _ = launch_train.build(args)
    assert mesh.shape == (1, 4)
