"""The benchmark's own tests, on the CPU at tiny sizes (``tiny.py``).

They cover the cells, configurations, traffic and metrics found as data,
the result line's shape, each cell against the reference, the control and
the faults the check has to catch, and the rule that nothing the benchmark
loads is JAX or its package. One test needs the card (``cuda``).
"""
import ast
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.control import ControlProgram
from perfbench.tests.tiny import CELLS, ROOT, VARIANTS, run_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_cells_configs_traffic_and_metrics_found_as_data(name):
    spec = harness.load_spec(name)
    assert spec.config["name"] == spec.entry["config"]
    assert spec.traffic["kind"] == "calibration_stage"
    assert callable(harness._module("traffic_kinds",
                                    spec.traffic["kind"]).make)
    import repro_torch.core as core
    assert isinstance(getattr(core, spec.traffic["policy"]), int)
    for key in ("warm_steps", "trace_steps", "judged_per_theta", "limits"):
        assert key in spec.cell
    assert {m["name"] for m in spec.end_to_end} == {"cluster_steps_per_s",
                                                    "setup_s"}
    for m in spec.end_to_end + spec.per_layer:
        assert callable(harness.reader(m["name"]).read)
    steps = spec.config["horizon_hours"] / spec.config["dt"]
    assert steps % spec.config["agg_refresh_steps"] == 0
    assert spec.cell["trace_steps"] % spec.config["agg_refresh_steps"] == 0


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = {p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")}
    assert files == {m["name"] for m in BENCH["end_to_end"]
                     + BENCH["per_layer"]}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(trace):
    res = run_tiny("paper_full.second.r240", trace=trace)
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["device"]["count"] == 1
    want = ({"idle_share", "kernels_per_step", "draw_ops_per_step",
             "draw_host_ms_per_step", "mc_agg_roofline"} if trace
            else {"cluster_steps_per_s", "setup_s"})
    # a CPU trace has no device events: those readers find nothing to read
    assert set(line["metrics"]) <= want
    if trace:
        assert line["metrics"]["draw_ops_per_step"]["value"] == 4 * 30
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def _ids(v):
    return v[0] + (".fleet" if v[1] else "")


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_tiny_cell_against_the_reference(variant):
    name, fleet = variant
    res = run_tiny(name, fleet=fleet)
    assert res["correct"], res["checks"]
    assert res["checks"]["count_gap"]["value"] == 0.0
    assert res["checks"]["flip_share"]["value"] == 0.0
    if fleet:
        assert res["checks"]["route_gap"]["value"] == 0.0


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_control_in_bfloat16_is_not_correct(variant):
    name, fleet = variant
    res = run_tiny(name, program_cls=ControlProgram, fleet=fleet)
    assert not res["correct"], res["checks"]


def _unchanged_state(mp):
    import repro_torch.sim.core as core
    orig = core._apply_step_events

    def step(cfg, slots, ev, cap, with_stats=False):
        _, out, stats = orig(cfg, slots, ev, cap, with_stats)
        return slots, out, stats
    mp.setattr(core, "_apply_step_events", step)


def _half_batch(mp):
    import repro_torch.sim as sim
    orig = sim.run_keyed_batch

    def half(run_fn, seeds, policy, *, streams=None, devices=None):
        seeds = list(seeds)
        h = len(seeds) // 2
        cut = lambda x: x[:h] if torch.is_tensor(x) and x.ndim else x
        out = orig(run_fn, seeds[:h], type(policy)(*map(cut, policy)),
                   streams=type(streams)(*(
                       type(x)(*map(cut, x)) if isinstance(x, tuple)
                       else cut(x) for x in streams)), devices=devices)
        pad = lambda x: (torch.cat([x, x[:len(seeds) - h]])
                         if torch.is_tensor(x) and x.ndim else x)

        def tree(x):
            if isinstance(x, tuple):
                return type(x)(*map(tree, x)) if hasattr(x, "_fields") \
                    else tuple(map(tree, x))
            return pad(x)
        return tree(out)
    mp.setattr(sim, "run_keyed_batch", half)


def _altered_answer(mp):
    import repro_torch.sim.core as core
    orig = core.admit_sequential

    def flip(*args, **kw):
        res = orig(*args, **kw)
        accept = res.accept.clone()
        accept[..., 0] = ~accept[..., 0] & args[6][..., 0]
        return res._replace(accept=accept)
    mp.setattr(core, "admit_sequential", flip)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_fault_in_the_timed_path_is_not_correct(variant, fault, monkeypatch):
    fault(monkeypatch)
    name, fleet = variant
    res = run_tiny(name, fleet=fleet)
    assert not res["correct"], res["checks"]


def _imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_its_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        names = set(_imported_names(path))
        assert not names & set(harness.FORBIDDEN), (path, names)


# what the run loads, and, planted, a module of the JAX package that the
# judge or a metric's reader loads after the window: the run has to end with
# no result in that case
_LATE_IMPORT = {
    "none": "",
    "in_the_judge": (
        "import perfbench.check as c; j = c.judge;"
        "c.judge = lambda *a: (sys.modules.setdefault('repro.core', sys),"
        " j(*a))[1];"),
    "in_a_reader": (
        "import perfbench.harness as h; r = h.reader;"
        "h.reader = lambda m: (sys.modules.setdefault('jax', sys),"
        " r(m))[1];"),
}


@pytest.mark.parametrize("late", sorted(_LATE_IMPORT))
def test_a_tiny_run_loads_no_jax_or_its_package(late):
    code = ("import sys; sys.path[:0] = ['src', '.'];" + _LATE_IMPORT[late]
            + "from perfbench.tests.tiny import run_tiny;"
            "res = run_tiny('paper_full.second.r240', trace=True,"
            " fleet=True);"
            "from perfbench import harness;"
            "print(harness.forbidden_modules(), res['correct'])")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if late == "none":
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout.strip().splitlines()[-1] == "[] True"
    else:
        assert out.returncode != 0 and out.stdout.strip() == ""
        assert "must not be" in out.stderr


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro", sys)
    assert "repro" in harness.forbidden_modules()


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "paper_full.zeroth.r192", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
