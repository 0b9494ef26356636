"""The port's roofline (``repro_torch.benchmarks.roofline``) on the CPU:
its terms on hand-built dry-run records against hand-computed ones, and
against the JAX package's ``benchmarks/roofline.py`` with that module's
constants set to the card's and its scan correction (which the port's eager
count does not need) set to 0."""
import importlib
import json
import sys
from pathlib import Path

import pytest

from repro_torch.benchmarks import roofline
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _jax_roofline():
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module("benchmarks.roofline")
    finally:
        sys.path.remove(str(ROOT))


def _record(kind="train", **kw):
    rec = {"status": "ok", "arch": "llama3.2-1b", "shape": f"{kind}_x",
           "kind": kind, "n_devices": 256, "global_batch": 256,
           "seq_len": 4096, "n_active_params": 1_235_814_400,
           "cost": {"flops": 7.19e14, "bytes accessed": 2.49e13},
           "collectives": {"total_wire_bytes": 5.73e9},
           "memory": {"temp_size_in_bytes": 3 * 2**30},
           "extrapolated": {"variant": "baseline"}}
    rec.update(kw)
    return rec


def test_terms_of_a_record_by_hand():
    rec = _record(cost_sum_over_devices={"flops": 1.15e16})
    a = roofline.analyze(rec)
    assert a["compute_s"] == pytest.approx(7.19e14 / 989e12, rel=1e-15)
    assert a["memory_s"] == pytest.approx(2.49e13 / 3.35e12, rel=1e-15)
    assert a["collective_s"] == pytest.approx(5.73e9 / 50e9, rel=1e-15)
    assert a["dominant"] == "memory"
    model_flops = 6 * 1_235_814_400 * 256 * 4096
    assert a["model_flops"] == model_flops
    assert a["hlo_flops_total"] == 1.15e16
    assert a["useful_flops_ratio"] == pytest.approx(model_flops / 1.15e16)
    ideal = model_flops / (256 * 989e12)
    assert a["roofline_fraction"] == pytest.approx(ideal / a["memory_s"])
    assert a["hbm_gib_per_dev"] == 3.0
    # decode: 2 N a token, one token a row; extrapolated figures first
    rec = _record("decode", extrapolated={"flops": 2e10, "bytes": 1e11,
                                          "wire_bytes": 6e9},
                  memory={})
    a = roofline.analyze(rec)
    assert a["model_flops"] == 2 * 1_235_814_400 * 256
    assert a["compute_s"] == 2e10 / 989e12
    assert a["collective_s"] == 6e9 / 50e9 and a["dominant"] == "collective"
    assert a["useful_flops_ratio"] == pytest.approx(
        a["model_flops"] / (2e10 * 256))
    assert a["hbm_gib_per_dev"] is None


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_analyze_matches_the_reference_at_the_cards_peaks(kind, monkeypatch):
    jax_roofline = _jax_roofline()
    monkeypatch.setattr(jax_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS)
    monkeypatch.setattr(jax_roofline, "HBM_BW", roofline.HBM_BW)
    monkeypatch.setattr(jax_roofline, "ICI_BW", roofline.LINK_BW)
    monkeypatch.setattr(jax_roofline, "_inner_scan_flops_correction",
                        lambda rec: 0.0)
    rec = _record(kind)
    got, want = roofline.analyze(rec), jax_roofline.analyze(rec)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=1e-12), key
        elif key != "hint":
            assert got[key] == value, key


def test_table_and_rows_from_records(tmp_path, monkeypatch):
    monkeypatch.setattr(roofline, "ART_DIR", str(tmp_path))
    assert roofline.run("tiny", 0, "cpu") == [
        "roofline/no_artifacts,0.0,run repro_torch.launch.dryrun first"]
    for mesh in ("single_pod", "multi_pod"):
        (tmp_path / f"llama3.2-1b_train_4k_{mesh}.json").write_text(
            json.dumps(_record(shape="train_4k")))
    (tmp_path / "hymba-1.5b_train_4k_single_pod.json").write_text(
        json.dumps({"status": "error", "arch": "hymba-1.5b"}))
    rows = roofline.run("tiny", 0, "cpu")
    assert [r.split(",")[0] for r in rows] == [
        "roofline/multi_pod/llama3.2-1b/train_4k",
        "roofline/single_pod/llama3.2-1b/train_4k"]
    table = roofline.table("single_pod").splitlines()
    assert len(table) == 3 and table[2].startswith(
        "| llama3.2-1b | train_4k |")
    assert table[2].endswith("| 3.0 |")
