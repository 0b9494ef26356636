"""The port's benchmark drivers (``repro_torch.benchmarks``: ``run``,
``tuning_bench``, ``serve_bench``, ``kernels_bench``) against the JAX
package's ``benchmarks/`` at small size, on the CPU.

* ``merge_records`` of both packages on the cases of
  ``tests/test_tuning.py::TestBenchArtifactMerge``: equal outputs.
* ``_calibrated_thetas`` of both packages on ``BENCH_quick.json`` and on a
  temporary file: equal.
* The row formatters: the same numbers give the same strings.
* ``tuning_bench.run("smoke")``: its K is the JAX package's selection
  (``parse_kcurve_rows`` then ``pick_from_curve``) on the port's rows.
* ``serve_bench.run("smoke")``: the JAX driver's row names, ``sharded``
  included; with the measurements stubbed alike, the same rows. The JAX
  ``run()`` is never run whole: its ``sharded`` row starts a subprocess
  with 8 XLA devices. The port's ``sharded`` row runs in-process, on 8
  logical devices (``REPRO_TORCH_DEVICE_COUNT``, restored afterwards).
* Every JAX module has its counterpart: ``--only roofline`` gives the
  ``roofline/no_artifacts`` row without dry-run records and a row a
  record with one (the sharded ``serve`` row and an unknown module are
  in the same test).
* ``kernels_bench`` on the CPU: the plain rows only; the fused aggregate
  equals the per-slot sum.
* ``run.main`` writes a ``--json`` file and merges into it.

The draws differ between the packages (``torch.Generator`` against PRNG
keys), so the drivers' measurements are not compared, only their machinery.
"""
import copy
import dataclasses
import json
import math
import os
import re
import sys
import types
from pathlib import Path

import pytest
import torch

from repro import tuning as RU
from repro_torch import tuning as PU
from repro_torch.benchmarks import kernels_bench, serve_bench, tuning_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks.common import SMOKE_SCALE
from repro_torch.serve import format_operating_derived, operating_row_name
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_benchmarks(name):
    """The JAX package's ``benchmarks.<name>``, imported through the repo
    root as tests/test_tuning.py imports it."""
    import importlib

    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(str(ROOT))


# -- merge_records: the cases of tests/test_tuning.py -----------------------

def _rows(*specs):
    return [dict(name=n, us_per_call=us, derived=d, seed=s)
            for n, us, d, s in specs]


MERGE_CASES = {
    "replace_by_name_and_track_provenance": (
        dict(scale="quick", seed=0, total_seconds=10.0,
             rows=_rows(("a", 1.0, "old", 0), ("b", 2.0, "old", 0))),
        ("quick", 1, 5.0, _rows(("b", 3.0, "new", 1), ("c", 4.0, "new", 1))),
        lambda seed, total, rows: (
            seed == "mixed" and total == 15.0
            and [r["name"] for r in rows] == ["a", "b", "c"]
            and rows[1]["derived"] == "new" and rows[1]["seed"] == 1
            and rows[0]["seed"] == 0)),
    "full_replacement_uses_fresh_provenance": (
        dict(scale="quick", seed=0, total_seconds=10.0,
             rows=_rows(("a", 1.0, "old", 0))),
        ("quick", 1, 5.0, _rows(("a", 2.0, "new", 1))),
        lambda seed, total, rows: (
            seed == 1 and total == 5.0
            and rows == _rows(("a", 2.0, "new", 1)))),
    "same_seed_keeps_seed": (
        dict(scale="quick", seed=0, total_seconds=1.0,
             rows=_rows(("kept", 1.0, "d", 0))),
        ("quick", 0, 2.0, _rows(("x", 1.0, "d", 0))),
        lambda seed, total, rows: seed == 0 and total == 3.0
        and len(rows) == 2),
    "different_scale_replaces_wholesale": (
        dict(scale="tiny", seed=0, total_seconds=9.0, rows=[{"name": "a"}]),
        ("quick", 2, 4.0, _rows(("z", 1.0, "d", 2))),
        lambda seed, total, rows: (
            seed == 2 and total == 4.0
            and rows == _rows(("z", 1.0, "d", 2)))),
}


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_records(impl, case, tmp_path):
    old, args, expected = MERGE_CASES[case]
    path = tmp_path / "BENCH_quick.json"
    path.write_text(json.dumps(old))
    fn = (_jax_benchmarks("run").merge_records if impl == "jax"
          else bench_run.merge_records)
    got = fn(str(path), *copy.deepcopy(args))
    assert expected(*got), got
    want = _jax_benchmarks("run").merge_records(str(path),
                                                *copy.deepcopy(args))
    assert got == want


# -- _calibrated_thetas ------------------------------------------------------

@pytest.mark.parametrize("source", ["committed", "tmp", "missing"])
def test_calibrated_thetas_equal_the_jax_drivers(source, tmp_path,
                                                 monkeypatch):
    jax_serve = _jax_benchmarks("serve_bench")
    if source == "tmp":
        path = tmp_path / "bench.json"
        path.write_text(json.dumps({"scale": "quick", "rows": [
            {"name": "tuning/calibrate/second",
             "derived": "theta=0.0812345 util=0.5"},
            {"name": "tuning/calibrate/zeroth", "derived": "theta=1.5e+03"},
            {"name": "tuning/calibrate/first", "derived": "no theta here"},
            {"name": "serve/quick/engine", "derived": "theta=9"}]}))
        monkeypatch.setenv("REPRO_BENCH_JSON", str(path))
    elif source == "missing":
        monkeypatch.setenv("REPRO_BENCH_JSON", str(tmp_path / "none.json"))
    else:
        monkeypatch.delenv("REPRO_BENCH_JSON", raising=False)
    got = serve_bench._calibrated_thetas("quick")
    assert got == jax_serve._calibrated_thetas("quick")
    if source == "committed":
        assert set(got) == {"zeroth", "first", "second"}
    elif source == "tmp":
        assert got == {"second": 0.0812345, "zeroth": 1500.0}
    else:
        assert got == {}


# -- the row formatters ------------------------------------------------------

MEASURES = [
    dict(decisions_per_s=1234.567, p50_ms=0.12345, p99_ms=9.87654,
         occupied=17, n_decisions=48),
    dict(decisions_per_s=3.2e5, p50_ms=1e-4, p99_ms=250.0, occupied=0,
         n_decisions=1),
]


@pytest.mark.parametrize("m", MEASURES, ids=["mid", "edge"])
def test_serve_row_formatters_equal_the_jax_drivers(m):
    jax_serve = _jax_benchmarks("serve_bench")
    from repro.serve import format_operating_derived as j_fmt
    from repro.serve import operating_row_name as j_name

    assert serve_bench._derived(m, 16, 1536) == jax_serve._derived(
        m, 16, 1536)
    for theta, cap, tau in ((0.0812345, 5000.0, 5e-4),
                            (1.23456789e4, 20_000.0, 1e-4)):
        assert (format_operating_derived(theta, cap, tau)
                == j_fmt(theta, cap, tau))
    assert (operating_row_name("quick", "second")
            == j_name("quick", "second"))
    assert serve_bench.FALLBACK_RHO == jax_serve.FALLBACK_RHO


@pytest.mark.parametrize("feasible", [True, False])
def test_kcurve_formatter_equals_the_jax_package(feasible):
    fields = dict(k=8, theta_fixed=0.0812345, util_fixed=0.51234,
                  slack_fixed=1.234e-4, theta_retuned=0.09,
                  util_retuned=0.52, slack_retuned=-2.5e-5,
                  retuned_feasible=feasible)
    got = PU.format_kcurve_derived(PU.KPoint(**fields))
    assert got == RU.format_kcurve_derived(RU.KPoint(**fields))
    assert PU.kcurve_row_name("quick", 8) == RU.kcurve_row_name("quick", 8)
    row = {"name": PU.kcurve_row_name("quick", 8), "derived": got}
    assert ([dataclasses.asdict(p)
             for p in PU.parse_kcurve_rows([row], "quick")]
            == [dataclasses.asdict(p)
                for p in RU.parse_kcurve_rows([row], "quick")])


# -- tuning_bench ------------------------------------------------------------

def test_tuning_bench_smoke_picks_the_jax_packages_k():
    rows = tuning_bench.run("smoke", device="cpu")
    names = [r.split(",", 2)[0] for r in rows]
    ks = RU.kcurve_divisors(
        int(SMOKE_SCALE.horizon_hours // SMOKE_SCALE.dt), k_max=4)
    assert names == ([f"tuning/calibrate/{k}"
                      for k in ("zeroth", "first", "second")]
                     + [RU.kcurve_row_name("smoke", k) for k in ks]
                     + ["tuning/pick_agg_refresh/smoke"])
    parsed = RU.parse_kcurve_rows(
        [{"name": n, "derived": r.split(",", 2)[2]}
         for n, r in zip(names, rows)], "smoke")
    assert [p.k for p in parsed] == ks
    k = int(re.match(r"K=(\d+)", rows[-1].split(",", 2)[2])[1])
    assert k == RU.pick_from_curve(parsed)
    for row in rows:
        assert math.isfinite(float(row.split(",", 2)[1]))
        assert not re.search(r"\b(nan|inf)\b", row, re.I), row


# -- serve_bench -------------------------------------------------------------

FAKE = dict(decisions_per_s=1000.0, p50_ms=1.5, p99_ms=3.25,
            us_per_decision=1000.0, occupied=12, n_decisions=48)
FAKE_DEADLINE = dict(p50_ms=50.0, p99_ms=99.0, mean_us=41000.0, misses=0,
                     n_flushes=6, n_decisions=24)


def _stub_measurements(module, monkeypatch):
    monkeypatch.setattr(module, "_measure", lambda *a, **k: dict(FAKE))
    monkeypatch.setattr(module, "_measure_telemetry_pair",
                        lambda *a, **k: (500.0, 520.0))
    monkeypatch.setattr(module, "_measure_deadline",
                        lambda *a, **k: dict(FAKE_DEADLINE))
    if hasattr(module, "_sharded_entry"):
        monkeypatch.setattr(module, "_measure_sharded",
                            lambda *a, **k: dict(FAKE))


@pytest.fixture()
def bench_with_thetas(tmp_path, monkeypatch):
    path = tmp_path / "BENCH_smoke.json"
    path.write_text(json.dumps({"scale": "smoke", "rows": [
        {"name": f"tuning/calibrate/{k}", "derived": f"theta={t}"}
        for k, t in (("zeroth", 800), ("first", 840), ("second", 0.1234))]}))
    monkeypatch.setenv("REPRO_BENCH_JSON", str(path))
    return path


def test_serve_bench_rows_equal_the_jax_drivers_but_sharded(
        bench_with_thetas, monkeypatch):
    """Both drivers' ``run`` at the smoke preset with their measurements
    stubbed alike: the same rows, in the same order, ``sharded`` (the
    mesh) included."""
    jax_serve = _jax_benchmarks("serve_bench")
    monkeypatch.setenv("REPRO_SMOKE", "1")
    _stub_measurements(jax_serve, monkeypatch)
    _stub_measurements(serve_bench, monkeypatch)
    rows = jax_serve.run("tiny")
    assert sum("/sharded," in r for r in rows) == 1
    assert serve_bench.run("smoke", device="cpu") == rows


def test_serve_bench_smoke_names_and_numbers(bench_with_thetas,
                                             monkeypatch):
    """The port's real ``run("smoke")`` on the CPU: the JAX driver's row
    names (``sharded`` on 8 logical devices), finite numbers, the operating
    points of the BENCH file's thetas, and no deadline miss counted
    twice."""
    jax_serve = _jax_benchmarks("serve_bench")
    monkeypatch.setenv("REPRO_SMOKE", "1")
    _stub_measurements(jax_serve, monkeypatch)
    want = [r.split(",", 1)[0] for r in jax_serve.run("tiny")]
    monkeypatch.delenv("REPRO_SMOKE")
    rows = serve_bench.run("smoke", device="cpu")
    assert [r.split(",", 1)[0] for r in rows] == want
    for row in rows:
        assert math.isfinite(float(row.split(",", 2)[1]))
        assert not re.search(r"\b(nan|inf)\b", row, re.I), row
    by = {r.split(",", 2)[0]: r.split(",", 2)[2] for r in rows}
    assert by["serve/smoke/operating_point/second"].startswith(
        "theta=0.1234 capacity=800")
    m = re.search(r"n=(\d+)", by["serve/smoke/deadline_flush"])
    assert int(m[1]) == 24           # 6 x width 4, every request decided
    assert by["serve/smoke/sharded"].endswith(" shards=8")


def test_rows_without_a_counterpart_raise_naming_their_items(monkeypatch,
                                                             tmp_path,
                                                             capsys):
    # serve_bench's sharded row has its counterpart now (the mesh): the
    # engine over 8 logical devices, the variable restored afterwards
    monkeypatch.setenv("REPRO_TORCH_DEVICE_COUNT", "2")
    m = serve_bench._measure_sharded("smoke", seed=0, width=4, n_ticks=1,
                                     per_tick=4, device="cpu")
    assert m["n_decisions"] == 4 and m["decisions_per_s"] > 0
    assert os.environ["REPRO_TORCH_DEVICE_COUNT"] == "2"
    # so has roofline (the dry run): no records, then one record
    from repro_torch.benchmarks import roofline
    monkeypatch.setattr(roofline, "ART_DIR", str(tmp_path))
    bench_run.main(["--only", "roofline", "--device", "cpu"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[1].startswith("roofline/no_artifacts,0.0,")
    rec = {"status": "ok", "arch": "llama3.2-1b", "shape": "train_4k",
           "kind": "train", "n_devices": 256, "global_batch": 256,
           "seq_len": 4096, "n_active_params": 1_235_814_400,
           "cost": {"flops": 7.0e14, "bytes accessed": 2.0e13},
           "collectives": {"total_wire_bytes": 5.0e9},
           "cost_sum_over_devices": {"flops": 1.12e16},
           "memory": {}, "extrapolated": {"variant": "baseline"}}
    (tmp_path / "llama3.2-1b_train_4k_single_pod.json").write_text(
        json.dumps(rec))
    bench_run.main(["--only", "roofline", "--device", "cpu"])
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 2 and rows[1].startswith(
        "roofline/single_pod/llama3.2-1b/train_4k,")
    assert "dom=memory" in rows[1]
    with pytest.raises(KeyError, match="unknown"):
        bench_run.main(["--only", "nope", "--device", "cpu"])
    assert not bench_run.NOT_PORTED
    assert set(bench_run.MODULES) == set(_jax_benchmarks("run").MODULES)


@pytest.mark.parametrize("name", sorted(bench_run.MODULES))
def test_every_driver_has_run(name):
    import inspect

    params = inspect.signature(bench_run.MODULES[name].run).parameters
    assert list(params)[:3] == ["scale_name", "seed", "device"]
    assert params["device"].default == "cuda"


# -- kernels_bench and run.main ----------------------------------------------

def test_kernels_bench_plain_rows_on_the_cpu(monkeypatch):
    # the loop rows at 8 of their 96 steps and one timed run: the rows,
    # not the rates, are under test here
    loop = kernels_bench._sim_loop_rows
    monkeypatch.setattr(kernels_bench, "_sim_loop_rows",
                        lambda device: loop(device, n_steps=8, reps=1))
    rows, out = kernels_bench.measure(device="cpu")
    names = [r.split(",", 1)[0] for r in rows]
    assert not any(n.endswith("_cuda") or "kernel_aggregate" in n
                   for n in names)
    assert names == ["kernels/moment_curves_continuous_torch",
                     "kernels/moment_curves_paper_cascade",
                     "kernels/aggregate_moment_curves_fused",
                     "sim/quick_loop_per_slot_recompute",
                     "sim/quick_loop_fused_aggregate",
                     "kernels/attention_ref"]
    # the fused aggregate equals the per-slot curves summed outside, up to
    # float32 summation order over 1,024 rows
    for got, want in zip(out["aggregate"], out["per_slot_sum"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert set(out) == {"curves", "per_slot_sum", "aggregate", "attention"}
    assert all(torch.isfinite(x).all() for x in out["curves"])


def test_run_main_writes_and_merges(tmp_path, monkeypatch, capsys):
    """The CLI into a new file, then another module's rows merged into it:
    the first rows kept, the new ones appended, no name twice, the compute
    accumulated, the seeds told apart, the device in every row; a list
    naming an unknown module runs none of them."""
    def module(*names):
        return types.SimpleNamespace(run=lambda scale_name, seed, device: [
            f"{n}/{scale_name},1.5,x={seed}" for n in names])

    monkeypatch.setitem(bench_run.MODULES, "one", module("a", "b"))
    monkeypatch.setitem(bench_run.MODULES, "two", module("b", "c"))
    path = tmp_path / "BENCH_tiny.json"
    bench_run.main(["--only", "one", "--device", "cpu", "--json",
                    str(path)])
    first = json.loads(path.read_text())
    assert (first["scale"], first["seed"], first["device"]) == ("tiny", 0,
                                                                "cpu")
    assert first["rows"] == [
        {"name": f"{n}/tiny", "us_per_call": 1.5, "derived": "x=0",
         "seed": 0, "device": "cpu"} for n in ("a", "b")]
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived", "a/tiny,1.5,x=0",
                   "b/tiny,1.5,x=0"]

    bench_run.main(["--only", "two", "--device", "cpu", "--json",
                    str(path), "--seed", "3"])
    second = json.loads(path.read_text())
    assert [(r["name"], r["seed"]) for r in second["rows"]] == [
        ("a/tiny", 0), ("b/tiny", 3), ("c/tiny", 3)]
    assert second["seed"] == "mixed" and second["device"] == "cpu"
    assert second["total_seconds"] >= first["total_seconds"]
    # every module of the list is checked before any of them runs
    capsys.readouterr()
    with pytest.raises(KeyError, match="unknown"):
        bench_run.main(["--only", "two,nope", "--device", "cpu"])
    assert capsys.readouterr().out == ""
