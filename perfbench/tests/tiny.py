"""Tiny CPU versions of the benchmark's cells, for its tests.

Each keeps its cell's configuration, traffic and check and cuts their
scale: 24 steps, 256 slots, at most 4 arrivals a step at 0.5 an hour, 3
seeds a theta, capacities over 25. ``fleet=True`` splits the cluster into
four of 128 slots behind the least utilized router, so that the fleet's
path (routes, one table a cluster) is checked too.
"""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

CELLS = ("paper_full.second.r240", "paper_full.zeroth.r192")
# (cell, fleet): every cell, and SECOND's as a fleet
VARIANTS = [(c, False) for c in CELLS] + [("paper_full.second.r240", True)]
SEED = 2 ** 31 + 7


def tiny_spec(name: str, fleet: bool = False) -> SimpleNamespace:
    spec = harness.load_spec(name)
    cfg = copy.deepcopy(spec.config)
    cfg.update(horizon_hours=24 * cfg["dt"], max_slots=256, max_arrivals=4,
               arrival_rate=0.5, capacity=500.0)
    if fleet:
        cfg.update(capacities=[200.0, 150.0, 100.0, 50.0], max_slots=128,
                   router="LeastUtilizedRouter")
    traffic = copy.deepcopy(spec.traffic)
    traffic["seeds_per_theta"] = 3
    if traffic["policy"] == "ZEROTH":
        traffic["thetas"] = [100.0, 300.0, 500.0]
    cell = copy.deepcopy(spec.cell)
    cell.update(warm_steps=12, trace_steps=24, judged_per_theta=1)
    if fleet:
        cell["limits"] = {"route_gap": 1e-4, **cell["limits"]}
    return SimpleNamespace(**{**vars(spec), "config": cfg,
                              "traffic": traffic, "cell": cell})


def run_tiny(name: str, trace: bool = False, seed: int = SEED,
             program_cls=None, fleet: bool = False) -> dict:
    return harness.run_cell(tiny_spec(name, fleet), seed, 0.0, trace,
                            device="cpu", log=lambda msg: None,
                            program_cls=program_cls)
