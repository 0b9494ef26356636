"""The port stands alone: nothing in ``src/repro_torch`` or ``chip_smoke.py``
imports JAX or the JAX package, and the port imports and runs with both
made unimportable."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    port = "src/repro_torch/"
    assert {"chip_smoke.py", port + "bridge.py", port + "device.py",
            port + "sim/core.py", port + "sim/simulator.py",
            port + "core/moments.py", port + "models/layers.py",
            port + "models/lm.py", port + "models/spec.py",
            port + "models/registry.py", port + "serve/engine.py",
            port + "launch/serve.py", port + "configs/llama3_2_1b.py",
            port + "serve/admission.py", port + "launch/admission_daemon.py",
            port + "obs/__init__.py", port + "obs/counters.py",
            port + "obs/export.py", port + "obs/log.py",
            port + "obs/tracing.py", port + "sim/routing.py",
            port + "benchmarks/fleet_bench.py",
            port + "core/policies.py", port + "tuning/calibrate.py"} <= names
    for kernel in ("moment_curves", "flash_attention", "decode_gqa"):
        for name in ("kernel.py", "ops.py", "ref.py"):
            assert f"{port}kernels/{kernel}/{name}" in names


def test_port_runs_with_jax_and_reference_blocked():
    code = """
import sys
for name in ("jax", "jaxlib", "repro", "flax"):
    sys.modules[name] = None
import repro_torch.bridge
from repro_torch.core import SECOND, geometric_grid, make_policy
from repro_torch.sim import make_config, make_run
cfg = make_config(capacity=200.0, arrival_rate=0.5, horizon_hours=48.0,
                  dt=24.0, max_slots=16, max_arrivals=3, d_points=8)
m = make_run(cfg, geometric_grid(24.0, 144.0, 6), SECOND, device="cpu")(
    0, make_policy(SECOND, rho=0.1, capacity=cfg.capacity))
assert m.util_trace.shape == (2,), m.util_trace.shape
assert not any(k.split(".")[0] in ("jax", "repro") and sys.modules[k]
               for k in sys.modules)
print("ok", float(m.utilization))
"""
    _run_blocked(code)


def _run_blocked(code: str):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_lm_runs_with_jax_and_reference_blocked():
    """A reduced LM forward through both attention lanes, then one engine
    step, with JAX and the JAX package unimportable."""
    code = """
import dataclasses, sys
for name in ("jax", "jaxlib", "repro", "flax"):
    sys.modules[name] = None
import numpy as np
import torch
from repro_torch.models import DecoderLM, build_model, get_config, reduced_config
from repro_torch.serve import Request, ServeEngine
cfg = reduced_config(get_config("llama3.2-1b"))
model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), device="cpu")
tokens = torch.randint(0, cfg.vocab, (2, 12))
flash = DecoderLM(dataclasses.replace(cfg, use_flash_kernel=True))
torch.testing.assert_close(flash.forward(params, tokens),
                           model.forward(params, tokens), rtol=1e-5, atol=1e-5)
engine = ServeEngine(model, params, max_batch=2, max_seq=16)
engine.submit(Request(rid=0, prompt=np.asarray([3, 4, 5], np.int32)))
assert engine.step() == 1
assert not any(k.split(".")[0] in ("jax", "repro") and sys.modules[k]
               for k in sys.modules)
print("ok")
"""
    _run_blocked(code)


def test_admission_engine_runs_with_jax_and_reference_blocked():
    """The online engine and the daemon's loop, with the telemetry rider
    and its Prometheus text, with JAX and the JAX package unimportable."""
    code = """
import sys
for name in ("jax", "jaxlib", "repro", "flax"):
    sys.modules[name] = None
from repro_torch.launch import admission_daemon as D
from repro_torch.obs import snapshot_to_prometheus
args = D.parse_args(["--capacity", "500", "--hours", "96", "--dt", "24",
                     "--max-slots", "32", "--micro-batch", "4",
                     "--param", "0.05", "--telemetry", "--device", "cpu"])
engine, stream, gen, _ = D.build_engine(args)
summary = D.serve_loop(engine, stream, gen)
assert summary["ticks"] == 4, summary
text = snapshot_to_prometheus(engine.metrics_snapshot())
assert "repro_admission_windows_total 4" in text, text
args = D.parse_args(["--capacity", "500", "--hours", "96", "--dt", "24",
                     "--max-slots", "32", "--micro-batch", "4",
                     "--param", "0.05", "--telemetry", "--device", "cpu",
                     "--fleet", "300,200"])
engine, stream, gen, _ = D.build_engine(args)
assert D.serve_loop(engine, stream, gen)["ticks"] == 4
text = snapshot_to_prometheus(engine.metrics_snapshot())
assert 'cluster="1"' in text, text
assert not any(k.split(".")[0] in ("jax", "repro") and sys.modules[k]
               for k in sys.modules)
print("ok")
"""
    _run_blocked(code)
