"""Roofline analysis: three terms per (arch × shape × mesh) cell from the
port's dry-run records (``repro_torch.launch.dryrun``, written to
``artifacts/dryrun_torch/``), at an NVIDIA H100's peaks.

    compute_s    = FLOPs of the busiest device       / 989e12 (bf16 dense)
    memory_s     = bytes of the busiest device       / 3.35e12 (HBM3)
    collective_s = wire bytes of the busiest device  / 50e9

The peaks are the card's (H100 SXM5: 989 TFLOP/s bf16 dense, 3.35 TB/s),
as ``PERF.md`` §6 uses them. The collective bandwidth is an assumption: a
16 × 16 mesh of H100s spans 32 nodes of 8, so its rings cross nodes, and a
ring is bound by its slowest link, the node's network rather than NVLink
(450 GB/s a direction inside a node). 50e9 B/s is one 400 Gb/s NDR
InfiniBand port a GPU, as an H100 node has.

The dry run counts every layer and every loop iteration eagerly (the JAX
package's count-while-bodies-once correction for the SSD chunk loop and
the sLSTM time loop has no counterpart: ``tests/test_torch_dryrun.py``
shows the count growing linearly in S there). MODEL_FLOPS = 6 · N_active ·
tokens (train) / 2 · N_active · tokens (inference). ``useful_flops_ratio``
is MODEL_FLOPS over the FLOPs counted on all devices: about 0.75 on a
train cell is remat (the forward runs twice, 8 N a token against 6 N), not
a fault. The reported fraction is ideal_time / max(term), the ideal time
being MODEL_FLOPS spread over every device of the mesh at peak: what the
cell could reach if it hit its binding roofline exactly. The port computes
a rank's rows on one device and leaves ``model`` idle, so its fraction is
at most 1 / (devices on ``model``).
"""
from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def analyze(rec: dict) -> dict:
    """The three terms, the binding one and the shares of one record (the
    port's, or the JAX package's form: per-device cost and no sum)."""
    n_dev = rec["n_devices"]
    ex = rec.get("extrapolated") or {}
    flops = ex.get("flops") or rec["cost"].get("flops", 0.0)
    bts = ex.get("bytes") or rec["cost"].get("bytes accessed", 0.0)
    wire = (ex.get("wire_bytes")
            if ex.get("wire_bytes") is not None
            else rec["collectives"]["total_wire_bytes"])
    total = (rec.get("cost_sum_over_devices") or {}).get("flops",
                                                         flops * n_dev)
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    collective_s = wire / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    tokens = (rec["global_batch"] * rec["seq_len"]
              if rec["kind"] in ("train", "prefill") else rec["global_batch"])
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * rec["n_active_params"] * tokens
    ideal_s = model_flops / (n_dev * PEAK_FLOPS)
    bound_s = max(terms.values())
    frac = ideal_s / bound_s if bound_s > 0 else 0.0
    useful = model_flops / total if total else 0.0

    hints = {
        "compute": "compute-bound: cut redundant FLOPs (remat policy, "
                   "a fused attention kernel) or spread a rank's work over "
                   "the model axis",
        "memory": "HBM-bound: shrink activation traffic (bf16 logits and "
                  "scores, fused kernels) or raise arithmetic intensity",
        "collective": "link-bound: reduce gather/reduce volume (weights "
                      "gathered once a step, overlap, gradient "
                      "compression)",
    }
    temp = rec["memory"].get("temp_size_in_bytes")
    return {
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": model_flops, "hlo_flops_total": total,
        "useful_flops_ratio": useful, "roofline_fraction": frac,
        "bound_s": bound_s, "hint": hints[dominant],
        "hbm_gib_per_dev": None if temp is None else temp / 2**30,
    }


def load_records(art_dir: str = None, mesh: str = None) -> list:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir or ART_DIR,
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        mesh_name = "multi_pod" if "multi_pod" in path else "single_pod"
        if mesh and mesh_name != mesh:
            continue
        rec["mesh_name"] = mesh_name
        out.append(rec)
    return out


def table(mesh: str = "single_pod", art_dir: str = None) -> str:
    recs = load_records(art_dir, mesh)
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant | "
        "MODEL_FLOPS | useful% | roofline_frac | temp GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in recs:
        a = analyze(rec)
        temp = ("not counted" if a["hbm_gib_per_dev"] is None
                else f"{a['hbm_gib_per_dev']:.1f}")
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {a['compute_s']:.3e} | "
            f"{a['memory_s']:.3e} | {a['collective_s']:.3e} | "
            f"{a['dominant']} | {a['model_flops']:.3g} | "
            f"{100*a['useful_flops_ratio']:.0f}% | "
            f"{a['roofline_fraction']:.3f} | {temp} |")
    return "\n".join(lines)


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    """A row a dry-run record (``scale_name``, ``seed`` and ``device`` are
    the CLI's; the analysis reads files only), or ``roofline/no_artifacts``
    without records."""
    from .common import csv_row
    rows = []
    for rec in load_records():
        a = analyze(rec)
        rows.append(csv_row(
            f"roofline/{rec['mesh_name']}/{rec['arch']}/{rec['shape']}",
            a["bound_s"] * 1e6,
            f"dom={a['dominant']} frac={a['roofline_fraction']:.3f} "
            f"useful={a['useful_flops_ratio']:.2f} "
            f"c/m/x={a['compute_s']:.2e}/{a['memory_s']:.2e}/"
            f"{a['collective_s']:.2e}"))
    if not rows:
        rows.append(csv_row("roofline/no_artifacts", 0.0,
                            "run repro_torch.launch.dryrun first"))
    return rows


if __name__ == "__main__":
    import sys
    print(table(sys.argv[1] if len(sys.argv) > 1 else "single_pod"))
