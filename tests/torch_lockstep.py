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
