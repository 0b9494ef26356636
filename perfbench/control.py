#!/usr/bin/env python3
"""The check's control: the plain reference in the system's place, in bfloat16.

The configurations state float32; the control computes every step of the
reference (counts, beliefs, curves, the policy's arithmetic, the router)
in the precision below, bfloat16, making its own decisions, and hands its
outputs to the harness as the system would. The check has to find it not
correct. The benchmark's runs never run it.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 \
        [--program-seeds 21 22 ...]

runs the cell on the card with the control in the system's place on each
of ``--seeds`` and the system itself on each of ``--program-seeds``, one
window of one batch a seed in one process, and prints one JSON line a run
with the numbers compared (the limits are set between the two sides'
readings) and what the judge saw.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                    str(Path(__file__).resolve().parents[1])]

from perfbench.reference import sim as ref  # noqa: E402


class ControlProgram:
    """``program.Program``'s interface over the reference run free in
    ``dtype``."""

    dtype = torch.bfloat16

    def __init__(self, config: dict, traffic, device, steps=None,
                 grid=None):
        self.device = torch.device(device)
        self.kind = traffic.policy
        self.setting = ref.setting(config, steps)
        self.grid = grid

    def run_batch(self, seeds, thetas, streams: dict) -> dict:
        st = {f: v[:, :self.setting.steps] for f, v in streams.items()}
        out = ref.simulate(self.setting, st, seeds, self.kind, thetas,
                           dtype=self.dtype, device=self.device)
        return {f: v for f, v in out.items() if torch.is_tensor(v)}


def main(argv=None) -> int:
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    spec = harness.load_spec(args.workload)
    runs = ([("control", ControlProgram, s) for s in args.seeds]
            + [("program", None, s) for s in args.program_seeds])
    for side, cls, seed in runs:
        res = harness.run_cell(spec, seed, 0.0, False, device="cuda",
                               program_cls=cls)
        print(json.dumps({
            "workload": args.workload, "side": side, "seed": seed,
            "correct": res["correct"],
            "readings": {k: v["value"] for k, v in res["checks"].items()},
            "judged": res["judged"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
