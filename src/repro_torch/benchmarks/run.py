"""One CLI over the port's benchmark drivers, one module a paper table or
figure or subsystem.

Prints ``name,us_per_call,derived`` CSV. Scale presets (``common.SCALES``):
  tiny  (default) minutes
  quick           tens of minutes on the CPU; minutes on the card
  full            the paper's c = 20,000 / 3-year / SLA 1e-4 setting

    python -m repro_torch.benchmarks.run [--scale tiny] [--only table2]
                                         [--json BENCH_torch_tiny.json]
                                         [--device cuda]

``--json`` also records the rows (with scale, seed and device metadata)
in a JSON file. When the file exists *for the same scale*, rows are merged
by name (matching rows replaced, new rows appended, the rest kept), so a
``--only`` subset refreshes its own rows instead of clobbering the file.
Each row carries the seed and the device it was measured with; the header's
``device`` is the card's name and power limit as ``nvidia-smi`` reports
them (or ``"cpu"``), ``"mixed"`` when merged rows disagree.

The drivers read their defaults (``tuning.pick_agg_refresh``'s K, the
thetas ``serve_bench`` serves at) from ``$REPRO_BENCH_JSON`` when it is
set, else from the JAX package's ``BENCH_<scale>.json``.

PyTorch counterpart of the JAX package's ``benchmarks/run.py``, on
``--device`` (the card unless the caller passes ``cpu``), module for
module. Its ``roofline`` rows read the port's dry-run records
(``python -m repro_torch.launch.dryrun``, in ``artifacts/dryrun_torch/``)
and need no device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import (ablation_marginal, drift_bench, fig1_priors, fig2_pricing,
               fleet_bench, kernels_bench, roofline, scenarios, serve_bench,
               table2_policies, tuning_bench)

MODULES = {
    "kernels": kernels_bench,
    "roofline": roofline,
    "table2": table2_policies,
    "fig1": fig1_priors,
    "fig2": fig2_pricing,
    "ablation_marginal": ablation_marginal,
    "scenarios": scenarios,
    "fleet": fleet_bench,
    "tuning": tuning_bench,
    "serve": serve_bench,
    "drift": drift_bench,
}

#: the JAX package's modules that the port has no counterpart of: none
NOT_PORTED: dict = {}


def merge_records(path: str, scale: str, seed: int, total: float,
                  records: list):
    """Merge fresh rows into an existing artifact by name (same scale only;
    an artifact of another scale is replaced).

    Provenance stays honest across subset merges: carried rows keep their
    own ``seed``, the artifact-level ``seed`` becomes ``"mixed"`` when the
    rows disagree, and ``total_seconds`` accumulates the compute recorded in
    the artifact rather than claiming the last subset run measured
    everything."""
    try:
        with open(path, encoding="utf-8") as f:
            old = json.load(f)
    except (OSError, ValueError):
        return seed, round(total, 1), records
    if old.get("scale") != scale:
        return seed, round(total, 1), records
    fresh = {r["name"]: r for r in records}
    carried = sum(1 for r in old.get("rows", []) if r["name"] not in fresh)
    merged = [fresh.pop(r["name"], r) for r in old.get("rows", [])]
    merged += list(fresh.values())
    if carried == 0:
        # nothing survived from the old artifact: this run's provenance is
        # the artifact's
        return seed, round(total, 1), merged
    # rows vote with their own seed; rows without one carry the old
    # header's
    seeds = {r.get("seed", old.get("seed")) for r in merged}
    seeds.discard(None)
    merged_seed = seeds.pop() if len(seeds) == 1 else "mixed"
    merged_total = round(float(old.get("total_seconds", 0.0)) + total, 1)
    return merged_seed, merged_total, merged


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the card of
    ``device``'s index), or ``"cpu"``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return lines[device.index or 0].strip()


def records_of(rows: list, seed: int, device: str) -> list:
    """The artifact's records of a driver's CSV rows."""
    out = []
    for row in rows:
        bench, us, derived = row.split(",", 2)
        out.append({"name": bench, "us_per_call": float(us),
                    "derived": derived, "seed": seed, "device": device})
    return out


def write_artifact(path: str, scale: str, seed: int, total: float,
                   records: list) -> list:
    """Write ``records`` (each with ``device``) to ``path``, merged into the
    artifact already there (``merge_records``); returns the rows written."""
    seed_out, total_s, rows = seed, round(total, 1), records
    if os.path.exists(path):
        seed_out, total_s, rows = merge_records(path, scale, seed, total,
                                                records)
    devices = {r.get("device") for r in rows}
    devices.discard(None)
    device = devices.pop() if len(devices) == 1 else "mixed"
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"scale": scale, "seed": seed_out, "device": device,
                   "total_seconds": total_s, "rows": rows}, f, indent=2)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="tiny",
                    choices=["tiny", "quick", "full"])
    ap.add_argument("--only", default=None,
                    help="comma-separated module subset: "
                    + ",".join(MODULES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write rows to a BENCH_<scale>.json artifact")
    args = ap.parse_args(argv)

    names = list(MODULES) if not args.only else args.only.split(",")
    for name in names:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"benchmark module {name!r} is not ported yet: "
                + NOT_PORTED[name])
        if name not in MODULES:
            raise KeyError(f"unknown benchmark module {name!r}; the port "
                           f"has {', '.join(MODULES)}")
    device = device_name(args.device)
    print("name,us_per_call,derived")
    t0 = time.time()
    records = []
    for name in names:
        try:
            for row in MODULES[name].run(args.scale, args.seed, args.device):
                print(row, flush=True)
                records += records_of([row], args.seed, device)
        except Exception as e:
            print(f"{name}/ERROR,0,{type(e).__name__}:{e}", flush=True)
            raise
    total = time.time() - t0
    if args.json:
        rows = write_artifact(args.json, args.scale, args.seed, total,
                              records)
        print(f"# wrote {args.json} ({len(rows)} rows)", file=sys.stderr)
    print(f"# total_seconds={total:.0f}", file=sys.stderr)


if __name__ == "__main__":
    main()
