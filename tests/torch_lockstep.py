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

    def policies(kinds, thetas):
        policy = make_policy(kinds, threshold=thetas, rho=thetas,
                             capacity=cfg.capacity)
        return jax.tree.map(lambda x: jnp.broadcast_to(x, thetas.shape),
                            policy)

    @jax.jit
    def start(keys):
        k_stream, k_scan = jax.vmap(jax.random.split, out_axes=1)(keys)
        stream = jax.vmap(lambda k: draw_arrival_stream(k, cfg))(k_stream)
        step_keys = jax.vmap(lambda k: jax.random.split(k, cfg.n_steps))(
            k_scan)
        cs = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (keys.shape[0],) + x.shape),
            core.init())
        return stream, step_keys, cs

    return start, steps, policies


def reference_steps(cfg, grid, kinds, keys, thetas):
    """``reference_draws`` one step at a time: (stream, steps), ``steps`` a
    generator of the T steps' ``StepEvents`` (numpy [B, S] leaves), each
    drawn when it is asked for, so that a long run's events are never all
    held at once."""
    start, steps, policies = _stepper(cfg, tuple(np.asarray(grid).tolist()))
    stream, step_keys, cs = start(jnp.asarray(keys))
    policy = policies(jnp.asarray(kinds, jnp.int32),
                      jnp.asarray(thetas, jnp.float32))

    def events():
        nonlocal cs
        for t in range(cfg.n_steps):
            stream_t = jax.tree.map(lambda x: x[:, t], stream)
            cs, ev = steps[t % cfg.agg_refresh_steps == 0](
                policy, cs, step_keys[:, t], stream_t)
            yield jax.tree.map(np.asarray, ev)

    return jax.tree.map(np.asarray, stream), events()


def reference_draws(cfg, grid, kinds, keys, thetas):
    """(stream, events) of the reference's runs (keys[b], kinds[b],
    thetas[b]) (threshold and rho both theta, as calibration builds them;
    ``kinds`` one kind for all, or one a run): ``stream`` an
    ``ArrivalStream`` of numpy [B, T, A] leaves, and ``events`` a list of T
    ``StepEvents`` of numpy [B, S] leaves."""
    stream, events = reference_steps(cfg, grid, kinds, keys, thetas)
    return stream, list(events)
