"""The training loop around the step: data, checkpoints, fault tolerance,
the launcher and the example, on the CPU.

* ``make_batch`` equals the JAX package's bit for bit (tokens, labels,
  frames) for several (seed, step) pairs; the ``Prefetcher`` yields them in
  step order and ``close()`` returns.
* The checkpointer: round trip, the atomic ``LATEST``, the async save,
  ``shardings=`` refused, and a plain tree written by either package
  restored by the other, leaf for leaf.
* Mirrors of the JAX package's fault-tolerance tests
  (tests/test_checkpoint_ft.py), the end-to-end restart bit for bit with
  the uninterrupted run on the port.
* ``launch.train --reduced --device cpu`` through one injected failure, and
  ``examples.train_lm --smoke --device cpu``.
"""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_checkpointer
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro_torch.checkpoint import checkpointer
from repro_torch.data.pipeline import PipelineConfig, Prefetcher, make_batch
from repro_torch.examples import train_lm
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, get_config, reduced_config
from repro_torch.models.spec import tree_leaves
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 StragglerWatchdog,
                                                 run_with_restarts)
from repro_torch.train.step import init_train_state, make_train_step
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

PIPES = [dict(vocab=100, seq_len=16, global_batch=2),
         dict(vocab=256, seq_len=33, global_batch=3, seed=5),
         dict(vocab=51865, seq_len=8, global_batch=2, seed=1,
              frames_dim=12, enc_seq=24)]


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("kw", PIPES)
def test_make_batch_matches_reference_bit_for_bit(kw):
    for step in (0, 1, 7, 1000):
        got = make_batch(PipelineConfig(**kw), step)
        want = jax_make_batch(JaxPipelineConfig(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["tokens"][:, 1:],
                                  got["labels"][:, :-1])


def _close_within(pipe, seconds=10.0):
    t = threading.Thread(target=pipe.close, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "Prefetcher.close() hung"


def test_prefetcher_yields_steps_in_order_and_closes():
    cfg = PipelineConfig(vocab=50, seq_len=8, global_batch=2, frames_dim=4,
                         enc_seq=3)
    pipe = Prefetcher(cfg, device="cpu", start_step=3)
    for step in range(3, 8):
        got = next(pipe)
        want = make_batch(cfg, step)
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    _close_within(pipe)
    # closing a prefetcher whose queue is full and whose worker waits
    pipe = Prefetcher(cfg, device="cpu")
    while pipe._q.qsize() < cfg.prefetch:
        threading.Event().wait(0.01)
    _close_within(pipe)
    assert not pipe._thread.is_alive()


# -- checkpointer ------------------------------------------------------------

def _small_state():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "b": {"x": torch.ones(5), "step": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.zeros(2, dtype=torch.float64), None]}


def _assert_trees_equal(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_roundtrip(tmp_path):
    state = _small_state()
    checkpointer.save(str(tmp_path), 3, state)
    assert checkpointer.latest_step(str(tmp_path)) == 3
    _assert_trees_equal(
        checkpointer.restore(str(tmp_path), 3, state, device="cpu"), state)


def test_atomic_latest_pointer(tmp_path):
    state = _small_state()
    checkpointer.save(str(tmp_path), 1, state)
    checkpointer.save(str(tmp_path), 2, state)
    assert checkpointer.latest_step(str(tmp_path)) == 2
    assert os.path.isdir(tmp_path / "step_1")  # older kept
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    with open(tmp_path / "step_2" / "manifest.json") as f:
        manifest = json.load(f)
    assert sorted(manifest) == ["dtypes", "n_leaves", "n_shards", "shapes",
                                "step", "treedef"]
    assert manifest["n_leaves"] == 4 and manifest["n_shards"] == 1


def test_async_save_snapshots_before_returning(tmp_path):
    state = _small_state()
    ck = checkpointer.AsyncCheckpointer(str(tmp_path))
    ck.save_async(5, state)
    state["w"].add_(1.0)     # the snapshot was taken: this is not saved
    ck.wait()
    assert checkpointer.latest_step(str(tmp_path)) == 5
    out = checkpointer.restore(str(tmp_path), 5, state, device="cpu")
    torch.testing.assert_close(out["w"], state["w"] - 1.0, rtol=0, atol=0)


def test_restore_against_shardings_is_not_ported(tmp_path):
    """Restoring against shardings lays each leaf out over its mesh
    (tests/test_torch_train_mesh.py restores train states onto meshes)."""
    from repro_torch.device import Mesh
    from repro_torch.models.spec import (NamedSharding, PartitionSpec,
                                         Sharded, map_leaves)
    state = _small_state()
    checkpointer.save(str(tmp_path), 1, state)
    mesh = Mesh((torch.device("cpu"),) * 2, ("data", "model"), (1, 2))
    shardings = map_leaves(lambda x: NamedSharding(
        mesh, PartitionSpec(*(("model",) if x.ndim else ()))), state)
    got = checkpointer.restore(str(tmp_path), 1, state, shardings=shardings,
                               device="cpu")
    for g, w in zip(tree_leaves(got), tree_leaves(state)):
        assert isinstance(g, Sharded) and torch.equal(g.gather(), w)


def test_checkpoints_cross_between_packages(tmp_path):
    jax_state = {"w": jnp.arange(12.0).reshape(3, 4),
                 "b": {"x": jnp.ones(5), "step": jnp.asarray(7)},
                 "l": [jnp.full((2, 3), -1.5), None]}
    state = {"w": torch.zeros(3, 4), "b": {"x": torch.zeros(5),
                                           "step": torch.tensor(0)},
             "l": [torch.zeros(2, 3), None]}
    # the JAX package writes, the port reads
    jax_checkpointer.save(str(tmp_path / "jax"), 4, jax_state)
    got = checkpointer.restore(str(tmp_path / "jax"), 4, state,
                               device="cpu")
    want = jax.tree.map(np.asarray, jax_state)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # the port writes, the JAX package reads
    checkpointer.save(str(tmp_path / "port"), 9, got)
    assert jax_checkpointer.latest_step(str(tmp_path / "port")) == 9
    back = jax_checkpointer.restore(str(tmp_path / "port"), 9, jax_state)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert np.asarray(g).dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


# -- fault tolerance -----------------------------------------------------------

def test_run_with_restarts_resumes():
    """A loop that dies twice and resumes from its 'checkpoint'."""
    progress = {"step": 0, "restarts": 0}
    inj = FailureInjector(fail_at=(3, 7))

    def loop(_):
        for step in range(progress["step"], 10):
            inj.maybe_fail(step)
            progress["step"] = step + 1
        return progress["step"]

    final = run_with_restarts(
        loop, max_restarts=3,
        on_restart=lambda i, e: progress.__setitem__(
            "restarts", progress["restarts"] + 1))
    assert final == 10 and progress["restarts"] == 2


def test_injector_exhausts():
    inj = FailureInjector(fail_at=(1,))
    with pytest.raises(RuntimeError):
        inj.maybe_fail(1)
    inj.maybe_fail(1)  # second time: already fired


def test_straggler_watchdog():
    wd = StragglerWatchdog(warmup_steps=2, straggler_factor=2.0)
    for s in range(5):
        assert not wd.observe(s, 1.0)
    assert wd.observe(5, 5.0)
    assert len(wd.events) == 1
    assert not wd.observe(6, 1.0)  # ewma not polluted by the spike


def test_end_to_end_training_restart(tmp_path):
    """Train, crash, resume from the checkpoint, finish: every leaf of the
    final state equals the uninterrupted run's bit for bit (data is a pure
    function of step, the checkpoint at the crash boundary)."""
    cfg = reduced_config(get_config("llama3.2-1b"))
    model = build_model(cfg)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=8))
    pipe_cfg = PipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)

    def fresh():
        return init_train_state(model, torch.Generator().manual_seed(0),
                                device="cpu")

    def run_to(state, start, end, ckpt_every=4):
        for step in range(start, end):
            batch = {k: torch.from_numpy(v)
                     for k, v in make_batch(pipe_cfg, step).items()}
            state, _ = step_fn(state, batch)
            if (step + 1) % ckpt_every == 0:
                checkpointer.save(str(tmp_path), step + 1, state)
        return state

    ref = run_to(fresh(), 0, 8)                   # uninterrupted
    run_to(fresh(), 0, 5)                         # interrupted at step 5
    latest = checkpointer.latest_step(str(tmp_path))
    assert latest == 4
    resumed = checkpointer.restore(str(tmp_path), latest, fresh(),
                                   device="cpu")
    assert all(p.requires_grad for p in tree_leaves(resumed.params))
    resumed = run_to(resumed, latest, 8)
    _assert_trees_equal(resumed, ref)


# -- the launcher and the example -------------------------------------------

def test_launcher_survives_an_injected_failure(tmp_path, capsys):
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "8",
                       "--fail-at", "4", "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert "restart #1: injected node failure at step 4" in out
    assert "resumed from step" in out and "restart #2" not in out
    assert "[train] done at step 8" in out
    assert checkpointer.latest_step(str(tmp_path)) == 8
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert losses and all(np.isfinite(losses))


def test_restart_waits_for_the_save_in_flight(tmp_path, capsys,
                                              monkeypatch):
    """A save still being written when the step fails lands before the
    restart reads LATEST: the run resumes from it, not from step 0."""
    write = checkpointer._write
    started = threading.Event()

    def slow_write(directory, step, host, treedef):
        started.set()
        time.sleep(1.0)
        return write(directory, step, host, treedef)

    monkeypatch.setattr(checkpointer, "_write", slow_write)
    launch_train.main(["--reduced", "--device", "cpu", "--steps", "8",
                       "--fail-at", "5", "--ckpt-every", "4", "--ckpt-dir",
                       str(tmp_path)])
    out = capsys.readouterr().out
    assert started.is_set()
    assert "restart #1: injected node failure at step 5" in out
    assert "[train] resumed from step 4" in out
    assert "[train] done at step 8" in out


def test_train_lm_example_smoke(capsys):
    train_lm.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained to step 8 (through 1 injected failure + restart)" in out
