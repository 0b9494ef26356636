"""Table 2's calibration, the JAX package's against the port's on its draws
(and Fig. 1's and Fig. 2's).

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/torch_table2_witness.py \
        --scale quick [--kinds zeroth first second] [--seed 0] [--json PATH]
    ... tests/torch_table2_witness.py --scale tiny --figure fig1   # or fig2

For each policy kind (``--figure table2``, the default), or each row of the
figure's JAX driver (``fig1``: FIRST and SECOND with Def. 4's marginal
heuristic at the driver's pseudo-observation levels, keys from ``seed +
observations``; ``fig2``: SECOND with the heuristic, labeled and unlabeled
types, 5 observations each), at a ``benchmarks/common.py`` preset:

1. the JAX package's ``calibrate``, as its ``tune_and_eval`` calls it (the
   preset's keys ``split(PRNGKey(seed), n_runs)``, grid, tau and stages);
2. the port's ``calibrate`` with the same arguments, over a port
   ``make_run`` fed the JAX package's own draws for each (key, theta) it
   asks for (``torch_lockstep.reference_steps``, one step at a time, so a
   ``quick`` run's events are never all held at once).

It prints both results and whether the chosen theta, ``feasible``,
``n_sims``, the stages' thetas and failure rates agree. Equal results say
that the port's calibration and step reproduce the JAX package's on the same
draws; what is then left between the two packages' Table 2 is their draws
(``tests/test_torch_processes.py`` holds the port's samplers against the JAX
package's in distribution). CPU only: it runs the JAX package.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from benchmarks import common as RC
from repro.sim import make_run as r_make_run
from repro.tuning import calibrate as r_calibrate
from repro_torch import bridge
from repro_torch.core import FIRST, SECOND, ZEROTH
from repro_torch.sim import make_run
from repro_torch.tuning import calibrate
from torch_lockstep import port_config, reference_steps

KINDS = {"zeroth": ZEROTH, "first": FIRST, "second": SECOND}


class _Steps:
    """The ``events`` of a port run, drawn by the JAX package step by step
    as the run asks for them (in order)."""

    def __init__(self, steps, n_steps):
        self.steps, self.n_steps, self.t = steps, n_steps, 0

    def __len__(self):
        return self.n_steps

    def __getitem__(self, t):
        assert t == self.t, (t, self.t)
        self.t += 1
        return bridge.from_reference(next(self.steps))


class InjectedRuns:
    """A port ``make_run`` run on the JAX package's draws: a run's seed is
    the index of its key."""

    def __init__(self, cfg, grid, keys, kind):
        self.cfg, self.grid, self.keys, self.kind = cfg, grid, keys, kind
        self.run = make_run(port_config(cfg), np.asarray(grid), kind,
                            device="cpu")

    def __call__(self, seeds, policy, stream=None):
        assert stream is None
        seeds = list(seeds)
        thetas = policy.threshold.numpy().tolist()
        marginal = bool((policy.marginal_eps > 0).any())
        ref_stream, steps = reference_steps(self.cfg, self.grid, self.kind,
                                            self.keys[seeds], thetas,
                                            marginal)
        return self.run(seeds, policy,
                        stream=bridge.from_reference(ref_stream),
                        events=_Steps(steps, self.cfg.n_steps))


def _summary(res, seconds):
    return dict(
        theta=float(res.theta), feasible=bool(res.feasible),
        n_sims=int(res.n_sims), sla_fail=float(res.sla_fail),
        sla_lo=float(res.sla_lo), sla_hi=float(res.sla_hi),
        utilization=float(res.utilization),
        stages=[dict(thetas=[float(x) for x in st.thetas],
                     agg_fail=[float(x) for x in st.agg_fail],
                     util=[float(x) for x in np.mean(st.util, axis=-1)])
                for st in res.stages],
        seconds=seconds)


def _agree(ref, port) -> dict:
    same = lambda a, b: bool(np.array_equal(np.asarray(a), np.asarray(b)))
    stages = len(ref["stages"]) == len(port["stages"])
    return dict(
        theta=ref["theta"] == port["theta"],
        feasible=ref["feasible"] == port["feasible"],
        n_sims=ref["n_sims"] == port["n_sims"],
        stage_thetas=stages and all(same(r["thetas"], p["thetas"])
                                    for r, p in zip(ref["stages"],
                                                    port["stages"])),
        stage_fail=stages and all(same(r["agg_fail"], p["agg_fail"])
                                  for r, p in zip(ref["stages"],
                                                  port["stages"])),
        utilization_rel=abs(port["utilization"] - ref["utilization"])
        / max(abs(ref["utilization"]), 1e-30))


def cases(figure, scale_name, seed, kinds):
    """(row name, kind, prior mode, observations, marginal, seed) of each
    row the figure's JAX driver runs."""
    if figure == "table2":
        return [(name, KINDS[name], "global", 0, False, seed)
                for name in kinds]
    if figure == "fig1":
        levels = (0, 1, 5) if scale_name == "tiny" else (0, 1, 5, 50)
        return [(f"{name}_obs{n}", KINDS[name],
                 "pseudo" if n else "global", n, True, seed + n)
                for name in ("first", "second") for n in levels]
    return [(mode, SECOND, mode, 5, True, seed)
            for mode in ("labeled", "unlabeled")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="quick", choices=sorted(RC.SCALES))
    ap.add_argument("--figure", default="table2",
                    choices=("table2", "fig1", "fig2"))
    ap.add_argument("--kinds", nargs="+", default=list(KINDS),
                    choices=list(KINDS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    scale = RC.SCALES[args.scale]
    out = {}
    for name, kind, mode, n_obs, marginal, seed in cases(
            args.figure, args.scale, args.seed, args.kinds):
        cfg = RC.sim_config(scale, prior_mode=mode, n_pseudo_obs=n_obs)
        grid = RC.grid_for(scale, cfg)
        keys = jax.random.split(jax.random.PRNGKey(seed), scale.n_runs)
        print(f"{args.scale} {name}: {cfg.n_steps} steps, {cfg.max_slots} "
              f"slots, refresh every {cfg.agg_refresh_steps}, "
              f"{scale.n_runs} runs, tau {scale.tau:g}, seed {seed}, prior "
              f"{mode} ({n_obs} observations), marginal {marginal}",
              flush=True)
        kw = dict(capacity=cfg.capacity, tau=scale.tau,
                  n_grid=scale.n_thresholds + (2 if kind == SECOND else 0),
                  max_stages=2, marginal=marginal)
        t0 = time.perf_counter()
        ref = _summary(r_calibrate(r_make_run(cfg, grid, kind), kind, keys,
                                   **kw), time.perf_counter() - t0)
        print(f"{name}: the JAX package: {json.dumps(ref)}", flush=True)
        t0 = time.perf_counter()
        port = _summary(calibrate(InjectedRuns(cfg, grid, np.asarray(keys),
                                               kind),
                                  kind, range(scale.n_runs), **kw),
                        time.perf_counter() - t0)
        print(f"{name}: the port on its draws: {json.dumps(port)}",
              flush=True)
        agree = _agree(ref, port)
        print(f"{name}: agree {json.dumps(agree)}", flush=True)
        out[name] = dict(reference=ref, port=port, agree=agree)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(scale=args.scale, seed=args.seed,
                           figure=args.figure, rows=out), f, indent=1)


if __name__ == "__main__":
    main()
