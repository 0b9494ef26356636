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
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "bridge.py", "core.py", "simulator.py",
            "kernel.py", "ops.py", "ref.py", "moments.py"} <= names


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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
