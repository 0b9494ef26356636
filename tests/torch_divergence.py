"""The first decision at which the port leaves the JAX package, on its draws.

    PYTHONPATH=src:tests:. JAX_PLATFORMS=cpu python tests/torch_divergence.py \
        --scale quick --kind first --theta 1000 [--seed 0] [--json PATH] \
        [--save PATH.npz]

At a ``benchmarks/common.py`` preset, for the preset's runs (keys
``split(PRNGKey(seed), n_runs)``) at one theta of one policy kind:

1. the JAX package's admission core is stepped as its ``make_run`` steps
   it (``vmap`` over runs, refresh every ``agg_refresh_steps``), recording
   each step's events, each candidate's decision, score and bound, and the
   aggregate the decisions read; its final counts are held against the JAX
   package's own ``eval_theta_grid`` on the same keys (the stepped core must
   be the run the witness compares with);
2. the port's core is stepped beside it on the same stream and events.

At the first step where any run's decisions differ it prints the step, the
run and the candidate; both packages' margins ``bound - score`` relative to
the bound (FIRST: the threshold against max E[L] after admission; SECOND:
rho against the largest Cantelli mass); and the relative gap between the
two packages' aggregates E[L], V[L] at that step, with the gap the last
refresh left and what the steps since then added. ``--save`` writes the
JAX package's state before that step's decisions (the slot table, the
aggregate, the step's arrivals) and its decisions, for a test that replays
the step. CPU only: it runs the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from benchmarks import common as RC
from repro.core import FIRST, SECOND, ZEROTH, make_policy
from repro.core.processes import sample_step_events
from repro.sim import make_admission_core
from repro.sim.simulator import _accumulate_step
from repro.tuning import eval_theta_grid
from repro_torch import bridge
from repro_torch.core import make_policy as t_make_policy
from repro_torch.sim import make_admission_core as t_make_admission_core
from repro_torch.sim.simulator import _accumulate_step as t_accumulate_step
from torch_lockstep import port_config, start_runs

KINDS = {"zeroth": ZEROTH, "first": FIRST, "second": SECOND}


@functools.lru_cache(maxsize=None)
def _traced_stepper(cfg, grid: tuple, kind: int):
    core = make_admission_core(cfg, jnp.asarray(grid, jnp.float32), kind)

    def step(policy, cs, key, stream_t, refresh: bool):
        if refresh:
            cs = core.refresh_aggregates(cs)
        agg = (cs.agg_el, cs.agg_vl)
        events = sample_step_events(key, cs.slots.params, cs.slots.cores,
                                    cfg.priors, cfg.dt, alive=cs.slots.alive)
        cs, out = core.apply_events(key, cs)
        before = cs
        valid = jnp.arange(cfg.max_arrivals) < stream_t.n_arrivals
        cs, accept, diag = core.decide_batch_traced(
            policy, cs, out.util, core.candidates(stream_t), stream_t, valid)
        n_acc = jnp.sum(accept.astype(jnp.float32))
        n_rej = jnp.sum(valid.astype(jnp.float32)) - n_acc
        slots, _ = _accumulate_step(cs.slots, out, n_acc, n_rej, cfg.dt)
        return (cs._replace(slots=slots), events, accept, diag, agg, before,
                out.util)

    return core, {refresh: jax.jit(jax.vmap(functools.partial(
        step, refresh=refresh))) for refresh in (False, True)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def trace(cfg, grid, kind, keys, thetas):
    """Step both packages; returns a dict of what was found (and the JAX
    package's state before the first diverging decision, if any)."""
    runs = len(keys)
    _, steps = _traced_stepper(cfg, tuple(np.asarray(grid).tolist()), kind)
    stream, step_keys, cs = start_runs(cfg, grid, keys)
    policy = make_policy(kind, threshold=jnp.asarray(thetas, jnp.float32),
                         rho=jnp.asarray(thetas, jnp.float32),
                         capacity=cfg.capacity)
    policy = jax.tree.map(lambda x: jnp.broadcast_to(x, (runs,)), policy)

    tcfg = port_config(cfg)
    tcore = t_make_admission_core(tcfg, np.asarray(grid), kind, device="cpu")
    tpolicy = t_make_policy(kind, threshold=torch.tensor(thetas),
                            rho=torch.tensor(thetas), capacity=cfg.capacity)
    tstream = bridge.from_reference(jax.tree.map(np.asarray, stream))
    tcs = tcore.init(runs)
    arange = torch.arange(cfg.max_arrivals)

    found, refresh_gap, worst_gap = None, 0.0, 0.0
    last_refresh = {}
    for t in range(cfg.n_steps):
        refresh = t % cfg.agg_refresh_steps == 0
        stream_t = jax.tree.map(lambda x: x[:, t], stream)
        start = cs
        cs, ev, accept, diag, agg, before, util = steps[refresh](
            policy, cs, step_keys[:, t], stream_t)
        if found is not None:
            continue        # the JAX package runs on to its final counts
        if refresh:
            refreshed = (start.slots, agg)
            tcs = tcore.refresh_aggregates(tcs)
            last_refresh = dict(el=_rel(tcs.agg_el.numpy(), agg[0]),
                                vl=_rel(tcs.agg_vl.numpy(), agg[1]), step=t)
            refresh_gap = max(refresh_gap, last_refresh["el"])
        gap = dict(el=_rel(tcs.agg_el.numpy(), agg[0]),
                   vl=_rel(tcs.agg_vl.numpy(), agg[1]))
        worst_gap = max(worst_gap, gap["el"])
        t_before, out = tcore.observe_events(
            tcs, bridge.from_reference(jax.tree.map(np.asarray, ev)))
        st = _col(tstream, t)
        valid = arange < st.n_arrivals[:, None]
        tcand = tcore.candidates(tcore.candidate_rows(st))
        tcs, tacc, tdiag = tcore.decide_batch_traced(
            tpolicy, t_before, out.util, tcand, st, valid)
        n_acc = torch.sum(tacc.float(), -1)
        n_rej = torch.sum(valid.float(), -1) - n_acc
        slots, _ = t_accumulate_step(tcs.slots, out, n_acc, n_rej, cfg.dt)
        tcs = tcs._replace(slots=slots)
        acc = np.asarray(accept)
        differ = acc != tacc.numpy()
        if differ.any():
            r, a = (int(x[0]) for x in np.nonzero(differ))
            score, bound = float(diag.score[r, a]), float(diag.threshold[r, a])
            tscore = float(tdiag.score[r, a])
            cand = jax.vmap(_candidates(cfg, grid, kind))(stream_t)
            found = dict(
                step=t, run=r, candidate=a, n_arrivals=int(
                    stream_t.n_arrivals[r]),
                reference_accepts=bool(acc[r, a]),
                port_accepts=bool(tacc[r, a]),
                bound=bound, reference_score=score, port_score=tscore,
                reference_margin=(bound - score) / bound,
                port_margin=(bound - tscore) / bound,
                scores_rel=abs(tscore - score) / abs(score),
                agg_gap=dict(el=_rel(tcs_agg(t_before, r, 0), agg[0][r]),
                             vl=_rel(tcs_agg(t_before, r, 1), agg[1][r])),
                gap_after_last_refresh=last_refresh,
                candidate_gap=dict(
                    el=_rel(tcand.EL[r].numpy(), cand.EL[r]),
                    vl=_rel(tcand.VL[r].numpy(), cand.VL[r])),
                util_equal=bool(float(util[r]) == float(out.util[r])))
            found["state"] = _state(refreshed, agg, util, stream_t, policy,
                                    r, acc[r], diag, cand, grid, cfg)
    result = dict(first_divergence=found, refresh_gap_max=refresh_gap,
                  aggregate_gap_max=worst_gap,
                  steps_compared=(found["step"] if found else cfg.n_steps))
    if found is None:
        result["port_counts"] = dict(
            failed=tcs.slots.fail_requests.numpy().tolist(),
            requests=tcs.slots.total_requests.numpy().tolist())
    result["reference_counts"] = dict(
        failed=np.asarray(cs.slots.fail_requests).tolist(),
        requests=np.asarray(cs.slots.total_requests).tolist())
    return result


def tcs_agg(cs, r, i):
    return (cs.agg_el if i == 0 else cs.agg_vl)[r].numpy()


def _col(x, t):
    if isinstance(x, torch.Tensor):
        return x[:, t]
    return type(x)(*(_col(y, t) for y in x))


@functools.lru_cache(maxsize=None)
def _candidates_fn(cfg, grid: tuple, kind: int):
    core = make_admission_core(cfg, jnp.asarray(grid, jnp.float32), kind)
    return jax.jit(core.candidates)


def _candidates(cfg, grid, kind):
    return _candidates_fn(cfg, tuple(np.asarray(grid).tolist()), kind)


def _state(refreshed, agg, util, stream_t, policy, r, accept, diag, cand,
           grid, cfg):
    """Run r's JAX state for a replay of the step: the slot table the last
    refresh read and the aggregate it gave, the aggregate the step's
    decisions read (the refreshed one plus the candidates placed since),
    the step's arrivals and candidate curves, the active cores, and the
    decisions with their scores and bounds; numpy arrays."""
    pick = lambda x: np.asarray(x)[r]
    slots, agg_refresh = refreshed
    out = {f"refresh_{k}": pick(getattr(slots, k)) for k in ("alive", "cores")}
    out.update({f"refresh_bel_{k}": pick(v)
                for k, v in slots.bel._asdict().items()})
    out.update(refresh_agg_el=pick(agg_refresh[0]),
               refresh_agg_vl=pick(agg_refresh[1]),
               agg_el=pick(agg[0]), agg_vl=pick(agg[1]), util=pick(util),
               accept=accept, score=pick(diag.score),
               bound=pick(diag.threshold), cand_el=pick(cand.EL),
               cand_vl=pick(cand.VL), c0=pick(stream_t.c0),
               n_arrivals=pick(stream_t.n_arrivals), grid=np.asarray(grid),
               d_points=np.int32(cfg.d_points))
    out.update({f"policy_{k}": pick(v) for k, v in policy._asdict().items()})
    return out


def reference_counts(cfg, grid, kind, keys, theta):
    """The JAX package's own ``eval_theta_grid`` at one theta."""
    from repro.sim import make_run

    m = eval_theta_grid(make_run(cfg, grid, kind), kind, [theta], keys,
                        capacity=cfg.capacity)
    return dict(failed=np.asarray(m.failed_requests)[0].tolist(),
                requests=np.asarray(m.total_requests)[0].tolist(),
                utilization=np.asarray(m.utilization)[0].tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="quick", choices=sorted(RC.SCALES))
    ap.add_argument("--kind", default="first", choices=list(KINDS))
    ap.add_argument("--theta", type=float, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--save", default=None)
    args = ap.parse_args(argv)
    scale = RC.SCALES[args.scale]
    cfg = RC.sim_config(scale)
    grid = RC.grid_for(scale, cfg)
    keys = jax.random.split(jax.random.PRNGKey(args.seed), scale.n_runs)
    kind = KINDS[args.kind]
    theta = float(np.float32(args.theta))
    res = trace(cfg, grid, kind, keys, [theta] * scale.n_runs)
    res["reference_eval"] = reference_counts(cfg, grid, kind, keys, theta)
    res["stepped_equals_eval"] = (res["reference_counts"]["failed"]
                                  == res["reference_eval"]["failed"]
                                  and res["reference_counts"]["requests"]
                                  == res["reference_eval"]["requests"])
    state = (res["first_divergence"] or {}).pop("state", None)
    print(json.dumps(res, indent=1), flush=True)
    if args.save and state is not None:
        np.savez_compressed(args.save, **state)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
