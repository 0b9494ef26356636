"""The port's dry run (``repro_torch.launch.dryrun``) and its shapes, on the
CPU, against the JAX package and against counts made by hand.

* ``SHAPES`` and ``applicable`` equal the JAX package's for every arch;
  ``input_specs`` gives the shapes and dtypes of its ``ShapeDtypeStruct``s.
* ``VARIANTS`` and ``TRAIN_MICROBATCHES`` equal the JAX package's, and each
  variant names fields of the port's ``ModelConfig``.
* Counted FLOPs of reduced dense cells equal an analytic count: 2 N a token
  and the attention terms for prefill and decode; for a train step under
  remat 4 times the blocks' forward (forward, its recomputation, and a
  backward of twice the forward) and 3 times the head's, less each block's
  last matmul, which ``torch.utils.checkpoint`` does not recompute (it
  stops once every tensor the backward saves is back).
* The total counted FLOPs of a dense train cell at width 768 on a (2, 4)
  mesh against the JAX package's ``lower_cell(..., probes=True)``
  extrapolated FLOPs times 8, in one subprocess of 8 XLA devices.
* Collective bytes of a reduced (2, 2) train step: each rank's gathered
  copy and the rank-order reduce into each device's block, counted here
  from the shardings.
* The depth extrapolation equals the full count; the SSD chunk loop and
  the sLSTM time loop grow linearly in S; ``bin_counts`` is ``bincount``;
  a one-cell run of the CLI on a (16, 16) meta mesh writes an ``ok``
  record with the JAX record's keys.

Nothing here allocates a parameter: every count runs on ``meta`` tensors.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.models import get_config as jax_get_config
from repro.models import input_specs as jax_input_specs
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable
from repro_torch.device import Mesh
from repro_torch.launch import dryrun
from repro_torch.models import (ARCH_NAMES, ModelConfig, build_model,
                                get_config, input_specs, reduced_config)
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txlstm
from repro_torch.models.spec import init_params, tree_leaves
from repro_torch.train.step import abstract_train_state, state_shardings
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ROOT = os.path.join(os.path.dirname(__file__), "..")
#: the JAX record's keys (``repro.launch.dryrun.lower_cell``)
JAX_RECORD_KEYS = {
    "variant", "arch", "shape", "status", "mesh", "axis_names", "n_devices",
    "n_params", "n_active_params", "kind", "seq_len", "global_batch",
    "microbatches", "lower_s", "compile_s", "memory", "cost", "collectives",
    "extrapolated"}
#: the width of the cell held against XLA's cost analysis
WIDE = dict(d_model=768, n_heads=4, n_kv_heads=2, head_dim=192, d_ff=3072,
            vocab=2048, n_layers=2)
WIDE_SHAPE = ShapeConfig("wide_train", "train", 64, 8)

_JAX_REFERENCE = """
import dataclasses, json, os, sys
import jax
import numpy as np
jax.devices()
from jax.sharding import Mesh
from repro.configs.shapes import ShapeConfig
from repro.launch import dryrun as D
from repro.models import get_config
cfg = dataclasses.replace(get_config("llama3.2-1b"), **json.loads(sys.argv[1]))
D.get_config = lambda name: cfg
D.SHAPES["wide_train"] = ShapeConfig("wide_train", "train", 64, 8)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
rec = D.lower_cell("llama3.2-1b", "wide_train", mesh, verbose=False)
print(json.dumps({"flops": rec["extrapolated"]["flops"],
                  "n_devices": rec["n_devices"], "keys": sorted(rec),
                  "VARIANTS": D.VARIANTS,
                  "TRAIN_MICROBATCHES": D.TRAIN_MICROBATCHES}))
"""


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's record of the wide cell (a subprocess with 8 XLA
    devices, ~12 s) and its dry run's tables."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    wide = {k: v for k, v in WIDE.items()}
    out = subprocess.run([sys.executable, "-c", _JAX_REFERENCE,
                          json.dumps(wide)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(shape, names=("data", "model")):
    return Mesh([torch.device("meta")] * math.prod(shape), names, shape)


def _dense(arch="llama3.2-1b", **kw):
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype=torch.bfloat16, **kw)
    return cfg, build_model(cfg)


# ---------------------------------------------------------------------------
# shapes, specs and tables against the JAX package
# ---------------------------------------------------------------------------

def test_shapes_and_applicable_match_the_reference():
    assert list(SHAPES) == list(jshapes.SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jshapes.SHAPES[name])
    for arch in ARCH_NAMES:
        for name in SHAPES:
            assert applicable(get_config(arch), SHAPES[name]) == \
                jshapes.applicable(jax_get_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_the_reference(arch):
    for name in SHAPES:
        got = input_specs(get_config(arch), SHAPES[name])
        want = jax_input_specs(jax_get_config(arch), jshapes.SHAPES[name])
        assert set(got) == set(want)
        for key, spec in want.items():
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(spec.shape)
            assert str(got[key].dtype).split(".")[-1] == \
                jnp.dtype(spec.dtype).name


def test_tables_match_the_reference(jax_ref):
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert dryrun.VARIANTS == jax_ref["VARIANTS"]
    assert dryrun.TRAIN_MICROBATCHES == jax_ref["TRAIN_MICROBATCHES"]
    for overrides in dryrun.VARIANTS.values():
        assert set(overrides) - {"_serve_params"} <= fields


# ---------------------------------------------------------------------------
# FLOPs against analytic counts and against XLA's
# ---------------------------------------------------------------------------

def _analytic(cfg, kind, b, s):
    """FLOPs of the port's dense cells: matmuls of the blocks (2 N_mm a
    token), the einsum lane's attention (4 S_k H Dh a query: all S_k keys
    of a causal prompt or of the cache), the head (2 D V a logit row)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, kvd = cfg.n_heads * cfg.resolved_head_dim, \
        cfg.n_kv_heads * cfg.resolved_head_dim
    n_mm = 2 * d * hd + 2 * d * kvd + (3 if cfg.gated_mlp else 2) * d * f
    layers = cfg.n_layers
    if kind == "decode":               # b rows, a cache of s slots
        return b * (layers * (2 * n_mm + 4 * s * hd) + 2 * d * v)
    blocks = layers * (2 * n_mm * b * s + 4 * b * s * s * hd)
    if kind == "prefill":              # logits of the last position only
        return blocks + 2 * d * v * b
    head = 2 * d * v * b * s
    last = layers * 2 * f * d * b * s  # w_out, not recomputed
    return 4 * blocks + 3 * head - last


@pytest.mark.parametrize("arch", ["llama3.2-1b", "starcoder2-3b"])
@pytest.mark.parametrize("kind,b,s", [("prefill", 2, 32), ("decode", 4, 64),
                                      ("train", 2, 32)])
def test_counted_flops_match_the_analytic_count(arch, kind, b, s):
    cfg, model = _dense(arch)
    for shape in [(1, 1), (2, 2)]:
        c = dryrun.count_cell(cfg, model, ShapeConfig("x", kind, s, b),
                              _mesh(shape))
        assert sum(c["flops"]) == _analytic(cfg, kind, b, s)
        assert c["cross_device_ops"] == 0


def test_total_flops_match_xla_cost_analysis(jax_ref):
    """XLA's cost analysis counts elementwise FLOPs too (norms, softmax,
    SiLU, AdamW) and recomputes every block's last matmul under remat; the
    port's count plus that matmul is within 2% of XLA's at width 768,
    where elementwise work is under 1% of a matmul's."""
    cfg = dataclasses.replace(get_config("llama3.2-1b"), **WIDE)
    c = dryrun.count_cell(cfg, build_model(cfg), WIDE_SHAPE, _mesh((2, 4)))
    b, s = WIDE_SHAPE.global_batch, WIDE_SHAPE.seq_len
    last = cfg.n_layers * 2 * cfg.d_ff * cfg.d_model * b * s
    want = jax_ref["flops"] * jax_ref["n_devices"]
    assert sum(c["flops"]) + last == pytest.approx(want, rel=2e-2)
    # one rank a data coordinate computes; the model axis does not
    assert sum(1 for f in c["flops"] if f) == 2
    assert max(c["flops"]) == sum(c["flops"]) // 2


@pytest.mark.parametrize("arch,kind,s", [("llama3.2-1b", "train", 32),
                                         ("xlstm-125m", "prefill", 768)])
def test_extrapolation_equals_the_full_count(arch, kind, s, monkeypatch):
    """Depths 1 and 2 (2 and 4 for the alternating xLSTM stack) taken to 4
    layers; the xLSTM prefill also from 128 and 256 positions to 768."""
    cfg, _ = _dense(arch, n_layers=4)
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    shape = ShapeConfig("x", kind, s, 4)
    mesh = _mesh((2, 2) if kind == "train" else (1, 2))
    ex = dryrun.extrapolate_depth(arch, "baseline", shape, mesh, 2)
    full = dryrun.count_cell(cfg, build_model(cfg), shape, mesh, 2)
    k = 2 if arch.startswith("xlstm") else 1
    assert ex["probe_depths"] == [k, 2 * k]
    assert ex.get("probe_seq_lens") == ([128, 256] if k == 2 else None)
    assert ex["flops"] == full["flops"]
    assert ex["bytes"] == full["bytes"]
    for got, want in zip(ex["wire"], full["wire"]):
        assert {k: [int(n), int(b)] for k, (n, b) in got.items()} == want


@pytest.mark.parametrize("which", ["ssd", "slstm"])
def test_sequence_loops_grow_linearly(which):
    """An eager count sees every iteration of the SSD chunk loop and of the
    sLSTM time loop (XLA's counts a loop body once)."""
    cfg = reduced_config(get_config("hymba-1.5b" if which == "ssd"
                                    else "xlstm-125m"))
    gen = torch.Generator().manual_seed(0)
    if which == "ssd":
        scfg = cfg.ssm_config()
        params = init_params(gen, tssm.ssm_params(scfg), device="cpu")
        fn, lengths = (lambda p, x: tssm.ssm(p, scfg, x)), (128, 256, 512)
    else:
        xcfg = cfg.xlstm_config()
        params = init_params(gen, txlstm.slstm_params(xcfg), device="cpu")
        fn, lengths = (lambda p, x: txlstm.slstm(p, xcfg, x)), (16, 32, 64)
    flops = [sum(dryrun.count_function(
        fn, params, torch.empty(2, s, cfg.d_model, device="meta")).flops)
        for s in lengths]
    assert flops[0] > 0
    assert flops[1] == 2 * flops[0] and flops[2] == 4 * flops[0]


# ---------------------------------------------------------------------------
# collectives, memory and MoE
# ---------------------------------------------------------------------------

def test_collective_bytes_of_a_sharded_train_step():
    """Over (2, 2) two data ranks (devices 0 and 2) each gather a float32
    copy of every parameter (all-gather: the distinct blocks that lie on
    other devices), and each rank's gradient goes, block by block, to every
    device holding a block of it (reduce-scatter)."""
    cfg, model = _dense()
    mesh = _mesh((2, 2))
    c = dryrun.count_cell(cfg, model, ShapeConfig("x", "train", 32, 4), mesh)
    params = tree_leaves(abstract_train_state(model).params)
    shardings = tree_leaves(state_shardings(model, mesh).params)
    ranks = (0, 2)
    gather = {d: [0, 0] for d in range(4)}
    reduce = {d: [0, 0] for d in range(4)}
    for p, sh in zip(params, shardings):
        probe = dryrun.Sharded([None] * 4, sh, p.shape, None)
        size = {i: 4 * math.prod(b - a for a, b in probe.ranges(i))
                for i in range(4)}
        for r in ranks:
            for i in probe.unique():
                if i != r:
                    gather[r][0] += 1
                    gather[r][1] += size[i]
            for i in range(4):
                if i != r:
                    reduce[i][0] += 1
                    reduce[i][1] += size[i]
    for d in range(4):
        assert c["wire"][d]["all-gather"] == gather[d]
        assert c["wire"][d]["reduce-scatter"] == reduce[d]
    # the arguments a device holds: its blocks of the parameters and of
    # both moments (float32), the step (int32, on every device), and on
    # device 0 the batch's tokens and labels (int32 [4, 32])
    args, outs = dryrun._full_memory(cfg, model,
                                     ShapeConfig("x", "train", 32, 4), mesh)
    for d in range(4):
        state = 4 + 3 * sum(
            4 * math.prod(b - a for a, b in dryrun.Sharded(
                [None] * 4, sh, p.shape, None).ranges(d))
            for p, sh in zip(params, shardings))
        assert outs[d] == state
        assert args[d] == state + (2 * 4 * 32 * 4 if d == 0 else 0)


def test_live_bytes_high_water_mark():
    """Two [64, 64] float32 products alive at once, then one freed."""
    def fn(a):
        x = a @ a
        y = x @ a
        del x
        return y @ a

    c = dryrun.count_function(fn, torch.empty(64, 64, device="meta"))
    assert c.peak[0] == 2 * 64 * 64 * 4
    assert c.flops[0] == 3 * 2 * 64 ** 3


def test_bin_counts_equals_bincount():
    gen = torch.Generator().manual_seed(3)
    for n in (1, 4, 17):
        idx = torch.randint(0, n, (257,), generator=gen)
        assert torch.equal(tmoe.bin_counts(idx, n),
                           torch.bincount(idx, minlength=n))
    meta = tmoe.bin_counts(torch.empty(9, dtype=torch.int64, device="meta"),
                           5)
    assert meta.shape == (5,) and meta.dtype == torch.int64


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_moe_counts_on_meta(kind):
    """The global dispatch's buffers are [E, capacity]: the FLOPs of a MoE
    cell do not depend on the routing, so meta tensors count them."""
    cfg, model = _dense("moonshot-v1-16b-a3b")
    c = dryrun.count_cell(cfg, model, ShapeConfig("x", kind, 32, 4),
                          _mesh((2, 2)))
    assert sum(c["flops"]) > 0 and c["cross_device_ops"] == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_one_cell_on_the_production_mesh(monkeypatch, tmp_path, capsys):
    cfg, _ = _dense()
    monkeypatch.setattr(dryrun, "get_config", lambda name: cfg)
    monkeypatch.setitem(dryrun.SHAPES, "tiny_prefill",
                        ShapeConfig("tiny_prefill", "prefill", 32, 16))
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "tiny_prefill",
                     "--single-pod-only", "--out", str(tmp_path)])
    assert exit_.value.code == 0
    rec = json.loads(
        (tmp_path / "llama3.2-1b_tiny_prefill_single_pod.json").read_text())
    assert rec["status"] == "ok" and JAX_RECORD_KEYS <= set(rec)
    assert rec["mesh"] == [16, 16] and rec["n_devices"] == 256
    assert rec["devices_computing"] == 16 and rec["cross_device_ops"] == 0
    assert rec["cost"]["flops"] * 16 == rec["cost_sum_over_devices"]["flops"]
    assert set(rec["collectives"]) == {*dryrun.COLLECTIVES,
                                       "total_wire_bytes"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert "temp_size_in_bytes" not in rec["memory"]   # probed: not counted


def test_record_keys_match_the_reference(jax_ref):
    assert JAX_RECORD_KEYS == set(jax_ref["keys"])
