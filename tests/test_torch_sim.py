"""The port's simulator slice in lockstep with the JAX package.

The golden configuration of ``test_admission_core.py`` runs in both packages
on the same arrival stream and the same per-step events: the reference's
``make_admission_core`` functions under ``jax.jit`` in a Python loop (as the
online engine drives them), each step's events drawn by
``repro.core.processes.sample_step_events`` with that step's key — the draw
``apply_events`` makes inside — and the port's ``make_run`` fed the stream
and the event list. Decisions must be exactly equal (SECOND's on inputs
whose every decision margin is at least 1e-4), the slot table exactly equal,
and the run metrics equal to rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS, SECOND, ZEROTH, geometric_grid, make_policy
from repro.core.processes import sample_step_events
from repro.sim import SimConfig, draw_arrival_stream, make_admission_core
from repro.sim.simulator import _accumulate_step, _run_metrics
from repro_torch import bridge
from repro_torch.sim import SimConfig as TSimConfig
from repro_torch.sim import make_admission_core as t_make_admission_core
from repro_torch.sim import make_run as t_make_run

# the golden configuration of tests/test_admission_core.py
CFG = SimConfig(capacity=500.0, arrival_rate=0.08, horizon_hours=30 * 24.0,
                dt=24.0, max_slots=96, max_arrivals=4, d_points=8,
                priors=AZURE_PRIORS)
GRID = geometric_grid(24.0, 3 * 30 * 24.0, 12)
CASES = {
    "zeroth": (CFG, ZEROTH, dict(threshold=300.0), 0),
    # a threshold under the run's load, so that ZEROTH also rejects
    "zeroth_tight": (CFG, ZEROTH, dict(threshold=40.0), 0),
    "second_k3": (CFG._replace(agg_refresh_steps=3), SECOND, dict(rho=0.05),
                  1),
}
# the port's kernel lanes (their plain versions on the CPU) and its fused
# oracle lane, both against the reference's default fused lane
LANES = {"kernel": {}, "fused": dict(use_kernel=False, agg_backend="fused")}
MIN_MARGIN = 1e-4
RTOL_METRICS = 1e-5
# beliefs accumulate one lgamma-based update per step, and the two packages'
# lgamma differ in the last ulps: 1e-6 per update grows over 30 steps
RTOL_BELIEF = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg, **lane):
    fields = cfg._asdict()
    fields["priors"] = bridge.from_reference(cfg.priors)
    return TSimConfig(**fields)._replace(**lane)


def _reference_lockstep(name):
    """Drive the reference core step by step; record its stream, events,
    decisions, decision diagnostics, final state and metrics."""
    cfg, kind, pol_kw, seed = CASES[name]
    core = make_admission_core(cfg, GRID, kind)
    policy = make_policy(kind, capacity=cfg.capacity, **pol_kw)
    j_refresh = jax.jit(core.refresh_aggregates)
    j_apply = jax.jit(lambda k, cs: core.apply_events(k, cs))
    j_events = jax.jit(lambda k, slots: sample_step_events(
        k, slots.params, slots.cores, cfg.priors, cfg.dt, alive=slots.alive))

    def decide(policy, cs, util, stream_t, valid):
        cand = core.candidates(stream_t)
        return core.decide_batch_traced(policy, cs, util, cand, stream_t,
                                        valid)

    j_decide = jax.jit(decide)
    k_stream, k_scan = jax.random.split(jax.random.PRNGKey(seed))
    stream = draw_arrival_stream(k_stream, cfg)
    keys = jax.random.split(k_scan, cfg.n_steps)
    cs = core.init()
    events, accepts, scores, bounds, valids, states = [], [], [], [], [], []
    util_trace, fail_trace = [], []
    for t in range(cfg.n_steps):
        if t % cfg.agg_refresh_steps == 0:
            cs = j_refresh(cs)
        events.append(_np(j_events(keys[t], cs.slots)))
        cs, out = j_apply(keys[t], cs)
        stream_t = jax.tree.map(lambda x: x[t], stream)
        valid = jnp.arange(cfg.max_arrivals) < stream_t.n_arrivals
        cs, accept, diag = j_decide(policy, cs, out.util, stream_t, valid)
        n_acc = jnp.sum(accept.astype(jnp.float32))
        n_rej = jnp.sum(valid.astype(jnp.float32)) - n_acc
        slots, util_end = _accumulate_step(cs.slots, out, n_acc, n_rej,
                                           cfg.dt)
        cs = cs._replace(slots=slots)
        util_trace.append(util_end)
        fail_trace.append(out.failed)
        accepts.append(np.asarray(accept))
        scores.append(np.asarray(diag.score))
        bounds.append(np.asarray(diag.threshold))
        valids.append(np.asarray(valid))
        states.append(_np(cs.slots))
    metrics = _run_metrics(cfg, cs.slots, jnp.stack(util_trace),
                           jnp.stack(fail_trace))
    return dict(name=name, cfg=cfg, kind=kind, policy=_np(policy), stream=_np(stream),
                events=events, accept=np.stack(accepts),
                score=np.stack(scores), bound=np.stack(bounds),
                valid=np.stack(valids), states=states, metrics=_np(metrics))


@pytest.fixture(scope="module", params=sorted(CASES))
def ref(request):
    return _reference_lockstep(request.param)


def _margins(ref):
    valid = ref["valid"]
    return (np.abs(ref["score"] - ref["bound"])
            / np.abs(ref["bound"]))[valid]


@pytest.mark.parametrize("lane", sorted(LANES))
def test_make_run_matches_reference(ref, lane):
    if ref["kind"] == SECOND:
        # the decisions compared are all clear of the f32 tie region
        assert _margins(ref).min() >= MIN_MARGIN
    run = t_make_run(_port_cfg(ref["cfg"], **LANES[lane]), np.asarray(GRID),
                     ref["kind"], record_decisions=True, device="cpu")
    metrics, accept = run(
        0, bridge.from_reference(ref["policy"]),
        stream=bridge.from_reference(ref["stream"]),
        events=[bridge.from_reference(ev) for ev in ref["events"]])
    np.testing.assert_array_equal(accept.numpy(), ref["accept"])
    assert ref["accept"].any()
    if ref["name"] != "zeroth":   # the golden ZEROTH run admits every arrival
        assert (ref["valid"] & ~ref["accept"]).any()
    for name, want in ref["metrics"]._asdict().items():
        np.testing.assert_allclose(getattr(metrics, name).numpy(), want,
                                   rtol=RTOL_METRICS, err_msg=name)


@pytest.mark.parametrize("lane", sorted(LANES))
def test_core_state_matches_reference_each_step(ref, lane):
    """The port's AdmissionCore, stepped with the reference's events: the
    slot table equals the reference's after every step and every float leaf
    of the state stays float32."""
    cfg = _port_cfg(ref["cfg"], **LANES[lane])
    core = t_make_admission_core(cfg, np.asarray(GRID), ref["kind"],
                                 device="cpu")
    policy = bridge.from_reference(ref["policy"])
    stream = bridge.from_reference(ref["stream"])
    cs = core.init()
    for t in range(cfg.n_steps):
        if t % cfg.agg_refresh_steps == 0:
            cs = core.refresh_aggregates(cs)
        cs, out = core.observe_events(
            cs, bridge.from_reference(ref["events"][t]))
        stream_t = type(stream)(*(
            type(x)(*(y[t] for y in x)) if isinstance(x, tuple) else x[t]
            for x in stream))
        valid = torch.arange(cfg.max_arrivals) < stream_t.n_arrivals
        cs, accept = core.decide_batch(policy, cs, out.util,
                                       core.candidates(
                                           core.candidate_rows(stream_t)),
                                       stream_t, valid)
        np.testing.assert_array_equal(accept.numpy(), ref["accept"][t])
        want = ref["states"][t]
        np.testing.assert_array_equal(cs.slots.alive.numpy(), want.alive)
        np.testing.assert_array_equal(cs.slots.cores.numpy(), want.cores)
        for got_p, want_p in zip(cs.slots.params, want.params):
            np.testing.assert_array_equal(got_p.numpy(), want_p)
        for got_b, want_b in zip(cs.slots.bel, want.bel):
            np.testing.assert_allclose(got_b.numpy(), want_b,
                                       rtol=RTOL_BELIEF)
    leaves = [x for x in jax.tree.leaves(tuple(bridge.to_numpy(cs)))
              if x.dtype.kind == "f"]
    assert leaves and all(x.dtype == np.float32 for x in leaves)
    assert cs.slots.alive.dtype == torch.bool


def test_same_seed_same_run_and_conservation():
    cfg = _port_cfg(CASES["second_k3"][0])
    run = t_make_run(cfg, np.asarray(GRID), SECOND, device="cpu")
    from repro_torch.core import make_policy as t_make_policy

    policy = t_make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    a, b = run(3, policy), run(3, policy)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), err_msg=name)
    assert float(a.alive_end) == float(
        a.arrivals_accepted - a.slot_overflow - a.n_departed)
    assert float(a.arrivals_accepted) > 0
    c = run(4, policy)
    assert not np.array_equal(a.util_trace.numpy(), c.util_trace.numpy())


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA path runs in chip_smoke.py")
    cfg = _port_cfg(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_run(cfg, np.asarray(GRID), SECOND)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_make_admission_core(cfg, np.asarray(GRID), SECOND)


@pytest.mark.parametrize("change, match", [
    (dict(mesh=object()), "Telemetry, mesh and fleet"),
])
def test_unported_options_raise(change, match):
    # the telemetry rider is ported (tests/test_torch_telemetry.py); a
    # device mesh is not
    with pytest.raises(NotImplementedError, match=match):
        t_make_admission_core(_port_cfg(CFG), np.asarray(GRID), SECOND,
                              device="cpu", **change)


def test_config_validation_errors_match_reference():
    from repro_torch.sim import make_config as t_make_config
    from repro.sim import make_config

    for bad in (dict(agg_backend="nope"), dict(n_pseudo_obs=-1),
                dict(prior_mode="pseudo"), dict(agg_refresh_steps=7,
                                                horizon_hours=240.0,
                                                dt=24.0)):
        with pytest.raises(ValueError) as want:
            make_config(**bad)
        with pytest.raises(ValueError) as got:
            t_make_config(**bad)
        assert str(got.value) == str(want.value)
