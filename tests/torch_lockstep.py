"""The JAX package's own random draws, recorded for the port's tests.

The two packages' random bits differ, so a parity test drives the port with
the reference's draws: ``reference_draws`` runs the reference's admission
core step by step, as its ``make_run`` steps it (``vmap`` over runs, each
step ``jit``-compiled), for runs (key, theta) of one policy kind, and
records each run's pre-drawn arrival stream and each step's events (the
draw ``apply_events`` makes inside, from that step's key). A run's events
depend on its trajectory, so they are recorded per (key, kind, theta). The
core is built for SECOND: the ZEROTH and FIRST policies that runs of it may
carry take the decisions, and so the trajectories, of their own kinds'
cores (the curves a ZEROTH core leaves out are never read).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import SECOND, make_policy
from repro.core.processes import sample_step_events
from repro.sim import draw_arrival_stream, make_admission_core
from repro.sim.simulator import _accumulate_step
from repro_torch import bridge
from repro_torch.sim import SimConfig as PortSimConfig
from repro_torch.sim import make_run


def port_config(cfg):
    """The port's ``SimConfig`` of a reference ``SimConfig``."""
    fields = cfg._asdict()
    fields["priors"] = bridge.from_reference(cfg.priors)
    return PortSimConfig(**fields)


@functools.lru_cache(maxsize=None)
def _stepper(cfg, grid: tuple):
    core = make_admission_core(cfg, jnp.asarray(grid, jnp.float32), SECOND)

    def step(policy, cs, key, stream_t, refresh: bool):
        if refresh:
            cs = core.refresh_aggregates(cs)
        events = sample_step_events(key, cs.slots.params, cs.slots.cores,
                                    cfg.priors, cfg.dt, alive=cs.slots.alive)
        cs, out = core.apply_events(key, cs)
        valid = jnp.arange(cfg.max_arrivals) < stream_t.n_arrivals
        cs, accept = core.decide_batch(policy, cs, out.util,
                                       core.candidates(stream_t), stream_t,
                                       valid)
        n_acc = jnp.sum(accept.astype(jnp.float32))
        n_rej = jnp.sum(valid.astype(jnp.float32)) - n_acc
        slots, _ = _accumulate_step(cs.slots, out, n_acc, n_rej, cfg.dt)
        return cs._replace(slots=slots), events

    steps = {refresh: jax.jit(jax.vmap(functools.partial(step,
                                                         refresh=refresh)))
             for refresh in (False, True)}

    def policies(kinds, thetas, marginal):
        policy = make_policy(kinds, threshold=thetas, rho=thetas,
                             capacity=cfg.capacity, marginal=marginal)
        return jax.tree.map(lambda x: jnp.broadcast_to(x, thetas.shape),
                            policy)

    return steps, policies


@functools.lru_cache(maxsize=None)
def _starter(cfg, grid: tuple):
    core = make_admission_core(cfg, jnp.asarray(grid, jnp.float32), SECOND)

    @jax.jit
    def start(keys):
        k_stream, k_scan = jax.vmap(jax.random.split, out_axes=1)(keys)
        stream = jax.vmap(lambda k: draw_arrival_stream(k, cfg))(k_stream)
        step_keys = jax.vmap(lambda k: jax.random.split(k, cfg.n_steps))(
            k_scan)
        return stream, step_keys

    return start, core.init


def start_runs(cfg, grid, keys):
    """(stream, step_keys, cs) of the runs of ``keys`` as the reference's
    ``make_run`` starts them: each run's pre-drawn arrival stream ([B, T,
    A] leaves), its T step keys, and the empty core state with a leading
    [B] (the aggregate [B, N] for ``grid``'s N points)."""
    start, init = _starter(cfg, tuple(np.asarray(grid).tolist()))
    stream, step_keys = start(jnp.asarray(keys))
    cs = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(keys),) + x.shape), init())
    return stream, step_keys, cs


def reference_steps(cfg, grid, kinds, keys, thetas, marginal=False):
    """``reference_draws`` one step at a time: (stream, steps), ``steps`` a
    generator of the T steps' ``StepEvents`` (numpy [B, S] leaves), each
    drawn when it is asked for, so that a long run's events are never all
    held at once."""
    steps, policies = _stepper(cfg, tuple(np.asarray(grid).tolist()))
    stream, step_keys, cs = start_runs(cfg, grid, keys)
    policy = policies(jnp.asarray(kinds, jnp.int32),
                      jnp.asarray(thetas, jnp.float32), marginal)

    def events():
        nonlocal cs
        for t in range(cfg.n_steps):
            stream_t = jax.tree.map(lambda x: x[:, t], stream)
            cs, ev = steps[t % cfg.agg_refresh_steps == 0](
                policy, cs, step_keys[:, t], stream_t)
            yield jax.tree.map(np.asarray, ev)

    return jax.tree.map(np.asarray, stream), events()


def reference_draws(cfg, grid, kinds, keys, thetas, marginal=False,
                    pad_to=1):
    """(stream, events) of the reference's runs (keys[b], kinds[b],
    thetas[b]) (threshold and rho both theta, as calibration builds them,
    with Def. 4's marginal heuristic if ``marginal``; ``kinds`` one kind for
    all, or one a run): ``stream`` an ``ArrivalStream`` of numpy [B, T, A]
    leaves (``bel_alt`` the second mixture component in the §7 modes), and
    ``events`` a list of T ``StepEvents`` of numpy [B, S] leaves.

    ``pad_to``: the runs are stepped in a batch padded (with copies of the
    last run) to a multiple of ``pad_to``, so that batches of other sizes
    reuse one compiled step; each run's bits do not depend on the batch
    around it."""
    b = len(thetas)
    pad = (-b) % pad_to
    fill = lambda x: np.concatenate([np.asarray(x)] + [np.asarray(x)[-1:]]
                                    * pad)
    if np.ndim(kinds):
        kinds = fill(kinds)
    stream, events = reference_steps(cfg, grid, kinds, fill(keys),
                                     fill(thetas), marginal)
    cut = lambda tree: jax.tree.map(lambda x: x[:b], tree)
    return cut(stream), [cut(ev) for ev in events]


class InjectedRuns:
    """A port ``make_run`` run fed the reference's draws: run seeds are
    indices into ``keys``, and each (key, theta) asked for is recorded once
    by ``reference_draws`` (with Def. 4's marginal heuristic when the
    policy asks for it), in batches padded to a multiple of ``PAD_TO``."""

    PAD_TO = 36

    def __init__(self, cfg, grid, keys, kind):
        self.cfg, self.kind = cfg, kind
        self.grid, self.keys = grid, np.asarray(keys)
        self.run = make_run(port_config(cfg), np.asarray(grid), kind,
                            device="cpu")
        self.draws = {}

    def __call__(self, seeds, policy, stream=None):
        assert stream is None
        marginal = bool((policy.marginal_eps > 0).any())
        wanted = [(seed, theta, marginal) for seed, theta in
                  zip(seeds, policy.threshold.numpy().tolist())]
        new = sorted(set(wanted) - set(self.draws))
        if new:
            idx = [i for i, _, _ in new]
            ref_stream, events = reference_draws(
                self.cfg, self.grid, self.kind, self.keys[idx],
                [th for _, th, _ in new], marginal, pad_to=self.PAD_TO)
            for b, run in enumerate(new):
                self.draws[run] = (
                    type(ref_stream)(*(_row(x, b) for x in ref_stream)),
                    [type(ev)(*(x[b] for x in ev)) for ev in events])
        picked = [self.draws[run] for run in wanted]
        stream = _stack([s for s, _ in picked])
        events = [_stack(step) for step in zip(*(e for _, e in picked))]
        return self.run(list(seeds), policy,
                        stream=bridge.from_reference(stream),
                        events=[bridge.from_reference(ev) for ev in events])


def _row(x, b):
    return type(x)(*(_row(y, b) for y in x)) if isinstance(x, tuple) else x[b]


def _stack(trees):
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack(xs) for xs in zip(*trees)))
    return np.stack(trees)


# ---------------------------------------------------------------------------
# fleets: the JAX package's fleet draws
# ---------------------------------------------------------------------------


def port_fleet_config(fcfg):
    """The port's ``FleetConfig`` of a reference ``FleetConfig``."""
    return bridge.from_reference(fcfg)


def router_draws(name, key, n_clusters, width):
    """The random draws the JAX package's router ``name`` makes from
    ``key`` for ``width`` arrivals (as its ``route`` makes them), in the
    port's ``Router.draw`` form: None for a deterministic router."""
    shape = (width,)
    if name == "random":
        return np.array(jax.random.randint(key, shape, 0, n_clusters,
                                           dtype=jnp.int32))
    if name == "power_of_two":
        ka, kb = jax.random.split(key)
        first = jax.random.randint(ka, shape, 0, n_clusters, dtype=jnp.int32)
        off = jax.random.randint(kb, shape, 0, max(n_clusters - 1, 1),
                                 dtype=jnp.int32)
        return np.array(first), np.array(off)
    return None


def engine_route_draws(name, seed, tick, n_clusters, width):
    """The draws the JAX fleet engine's router makes in window ``tick`` of
    its events path (every slice of a window routes from one key)."""
    step_key = jax.random.fold_in(jax.random.PRNGKey(seed), tick)
    return router_draws(name, jax.random.fold_in(step_key, n_clusters),
                        n_clusters, width)


@functools.lru_cache(maxsize=None)
def _fleet_stepper(fcfg, grid: tuple, kind, router_name):
    from repro.sim import ROUTERS, RouteContext
    from repro.sim.simulator import _cluster_step_keys

    cfg = fcfg.base
    core = make_admission_core(cfg, jnp.asarray(grid, jnp.float32), kind)
    n_c = fcfg.n_clusters
    caps = jnp.asarray(fcfg.capacities, jnp.float32)
    router = ROUTERS[router_name]()

    def step(policy, cs, key, stream_t, refresh: bool):
        if refresh:
            cs = jax.vmap(core.refresh_aggregates)(cs)
        keys_c = _cluster_step_keys(key, n_c)
        events = jax.vmap(lambda k, s: sample_step_events(
            k, s.params, s.cores, cfg.priors, cfg.dt, alive=s.alive))(
                keys_c, cs.slots)
        cs, out = jax.vmap(
            lambda cap, k, cs_c: core.apply_events(k, cs_c, cap))(
                caps, keys_c, cs)
        valid = jnp.arange(cfg.max_arrivals) < stream_t.n_arrivals
        cand = core.candidates(stream_t)
        assign = router.route(jax.random.fold_in(key, n_c), RouteContext(
            cand=cand, c0=stream_t.c0, valid=valid, agg_el=cs.agg_el,
            agg_vl=cs.agg_vl, util=out.util, capacities=caps, policy=policy))
        assign = jnp.clip(assign, 0, n_c)
        mask = valid[None, :] & (assign[None, :] == jnp.arange(n_c)[:, None])
        cs, accept = jax.vmap(
            lambda pol_c, cs_c, u_c, m_c: core.decide_batch(
                pol_c, cs_c, u_c, cand, stream_t, m_c))(
                    policy, cs, out.util, mask)
        n_acc = jnp.sum(accept.astype(jnp.float32), axis=1)
        n_rej = jnp.sum(mask.astype(jnp.float32), axis=1) - n_acc
        slots, _ = _accumulate_step(cs.slots, out, n_acc, n_rej, cfg.dt)
        return cs._replace(slots=slots), events

    def run_draws(key, n_c=n_c, width=cfg.max_arrivals):
        return router_draws(router_name, jax.random.fold_in(key, n_c), n_c,
                            width)

    steps = {refresh: jax.jit(jax.vmap(functools.partial(step,
                                                         refresh=refresh)))
             for refresh in (False, True)}
    return steps, core.init, run_draws


def reference_fleet_draws(fcfg, grid, kind, keys, policies, router_name):
    """(stream, events, route_draws) of the JAX package's ``make_fleet_run``
    runs (keys[b], policies[b]) with ``router_name`` (``policies`` with
    [B, C] leaves, as ``jax.vmap`` of ``fleet_policy`` gives them): the
    fleet-wide streams (numpy [B, T, A] leaves), each step's ``StepEvents``
    of every cluster (numpy [B, C, S] leaves: the draws ``apply_events``
    makes from the step's cluster keys) and each step's router draws
    (``router_draws`` from ``fold_in(key_t, C)``, [B, A] leaves; None for
    a deterministic router). The runs are stepped as ``make_fleet_run``
    steps them (``vmap`` over runs), so their events are those of its
    trajectories."""
    from repro.sim import stream_config

    cfg = fcfg.base
    n_c = fcfg.n_clusters
    steps, init, run_draws = _fleet_stepper(
        fcfg, tuple(np.asarray(grid).tolist()), kind, router_name)
    keys = jnp.asarray(keys)
    k_stream, k_scan = jax.vmap(jax.random.split, out_axes=1)(keys)
    stream = jax.vmap(lambda k: draw_arrival_stream(
        k, stream_config(fcfg)))(k_stream)
    step_keys = jax.vmap(lambda k: jax.random.split(k, cfg.n_steps))(k_scan)
    cs = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(keys), n_c) + x.shape), init())
    events, draws = [], []
    for t in range(cfg.n_steps):
        stream_t = jax.tree.map(lambda x: x[:, t], stream)
        cs, ev = steps[t % cfg.agg_refresh_steps == 0](
            policies, cs, step_keys[:, t], stream_t)
        events.append(jax.tree.map(np.asarray, ev))
        per_run = [run_draws(k) for k in step_keys[:, t]]
        if per_run[0] is None:
            draws.append(None)
        elif isinstance(per_run[0], tuple):
            draws.append(tuple(np.stack(x) for x in zip(*per_run)))
        else:
            draws.append(np.stack(per_run))
    return jax.tree.map(np.asarray, stream), events, draws


def fleet_policies(kind, caps, thetas):
    """[B, C] JAX fleet policies of ``thetas`` (threshold and rho both
    theta, as a calibration closure builds them)."""
    from repro.core import fleet_policy

    return jax.vmap(lambda th: fleet_policy(kind, capacities=caps,
                                            threshold=th, rho=th))(
        jnp.asarray(thetas, jnp.float32))
