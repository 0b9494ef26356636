"""The port's CUDA kernels, simulator and LM on a card (marked ``cuda``;
skipped where no card is visible). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
inputs (moment curves: the JAX package's rtol 2e-4 on EL and 2e-3 on VL;
flash attention 2e-5 in float32 and one bf16 ulp in bf16, with p kept in
float32; GQA decode, float32 out, 3e-5 for either cache type), and repeat
launches must be bitwise equal. Both moment-curve kernels run in both
forms (packed rows, and the belief columns the simulator launches); the
aggregate must give equal bits in 50 replays of a CUDA graph, and each
moment-curve entry point must be one CUDA kernel a call (counted from a
CUDA graph of the call). The batched aggregate (R runs in one launch) must
match its plain version, equal one-run launches bit for bit run by run,
repeat in CUDA-graph replays and be one kernel a call; a batch of runs on
the card must equal its runs alone, also in the §6/§7 prior modes, where
the unlabeled mode's two mixture components go through one row launch
with the bits of two. The decode kernel
is also run at lengths
around its key tile and split share, must refuse a misaligned view, and
must be one CUDA kernel a call. The bf16 flash kernel is also run at sequence
lengths around its tiles, on views of a fused QKV tensor, and must refuse a
view that TMA cannot copy. A small
simulator run on the card must repeat bit for bit and conserve deployments,
the online engine on the card must equal that run bit for bit (and its
pump thread launch on the engine's stream), and a small LM on the card
must match the same LM on the CPU, as must each other architecture's
reduced config (flash lane forward, decode-kernel decode steps), and one
train step of each family's reduced config. Both attention kernels also
run at the families' G = 5, 6, 12 and 48. The mesh on one card (4 logical
devices, ``[cuda:0] * 4``): the sharded engine equals the unsharded one bit
for bit (decisions, every refreshed aggregate, metrics, rider), and a batch
and a calibration split over the 4 equal them on one. The decode kernel's
log-sum-exp form matches its plain version at the families' heads, and
each family's reduced decode over the 4 logical devices (its KV cache
sequence-sharded, the log-sum-exp form on each shard) equals the CPU's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from repro_torch.core.belief import GammaBelief
from repro_torch.kernels._graph import kernels_of_one_call
from repro_torch.kernels.moment_curves import kernel as K
from repro_torch.kernels.moment_curves import ops
from repro_torch.kernels.moment_curves import ref as R
from repro_torch.kernels.decode_gqa import kernel as DG
from repro_torch.kernels.decode_gqa import ref as DR
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.models import (ARCH_NAMES, DecoderLM, build_model,
                                get_config, reduced_config)
from repro_torch.sim import make_config, make_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(d, n, nd, device, runs=None):
    """Numpy-made beliefs of ``d`` slots ([D] columns, or [R, D] for
    ``runs`` runs) and the kernels' grid, on ``device``."""
    shape = d if runs is None else (runs, d)
    rng = np.random.default_rng(d + n + nd + 10_000 * (runs or 0))
    e = lambda base: torch.from_numpy(
        (base * np.exp(rng.standard_normal(shape))).astype(np.float32))
    bel = GammaBelief(e(0.31), e(0.58), e(0.49), e(0.45), e(0.26), e(0.055))
    cores = torch.from_numpy(
        (1.0 + rng.poisson(5.0, shape)).astype(np.float32))
    alive = torch.from_numpy(rng.random(shape) < 0.6)
    bel = GammaBelief(*(x.to(device) for x in bel))
    return (bel, cores.to(device), alive.to(device),
            geometric_grid(6.0, 78_840.0, n, device=device))


def _calls(which, d, n, nd, device):
    """(kernel launcher, plain version, their arguments) of one form."""
    bel, cores, alive, grid = _case(d, n, nd, device)
    t, idx, frac, _ = ops.curve_grid(grid, nd)
    if which == "rows_belief":
        return (K.moment_curves_belief, R.moment_curves_belief_ref,
                (bel, cores, t, idx, frac, nd, AZURE_PRIORS))
    if which == "agg_belief":
        return (K.moment_curves_agg_belief, R.moment_curves_agg_belief_ref,
                (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS))
    params = R.pack_rows(bel, cores, AZURE_PRIORS, alive=alive)
    if which == "rows":
        return (K.moment_curves_packed, R.moment_curves_packed_ref,
                (params, t, idx, frac, nd))
    return (K.moment_curves_agg_packed, R.moment_curves_agg_packed_ref,
            (params, t, idx, frac, nd))


@pytest.mark.parametrize("d,n,nd", [(1, 12, 8), (8, 48, 24), (300, 48, 32),
                                    (8193, 48, 24)])
@pytest.mark.parametrize("which", ["rows", "agg", "rows_belief",
                                   "agg_belief"])
def test_kernel_matches_plain_version(card, which, d, n, nd):
    kern, plain, args = _calls(which, d, n, nd, card)
    before = dict(K.LAUNCHES)
    el, vl = kern(*args)
    el2, vl2 = kern(*args)
    torch.cuda.synchronize()
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 2
    assert torch.equal(el, el2) and torch.equal(vl, vl2)
    want_el, want_vl = plain(*args)
    torch.testing.assert_close(el, want_el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(vl, want_vl, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("d", [1, 8192, 8193])
@pytest.mark.parametrize("which", ["agg", "agg_belief"])
def test_aggregate_in_cuda_graph_equals_eager(card, which, d):
    """The aggregate's cross-CTA counter is back at 0 after every launch:
    50 replays of a captured call, each followed by an eager call on
    another stream's counter, all give the eager call's bits."""
    kern, _, args = _calls(which, d, 48, 24, card)
    want = kern(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kern(*args)
    for _ in range(50):
        graph.replay()
        eager = kern(*args)
        torch.cuda.synchronize()
        for x, y, z in zip(got, eager, want):
            assert torch.equal(x, z) and torch.equal(y, z)


@pytest.mark.parametrize("which", ["rows", "agg"])
def test_entry_point_is_one_kernel(card, which):
    """An ``ops`` entry point launches the belief-form kernel and nothing
    else: no pack, no interpolation, no second pass over CTA partials."""
    bel, cores, alive, grid = _case(8192 if which == "agg" else 8, 48, 24,
                                    card)
    if which == "rows":
        call = lambda: ops.moment_curves_kernel(bel, cores, grid, AZURE_PRIORS,
                                                d_points=24)
    else:
        call = lambda: ops.aggregate_moment_curves_kernel(
            bel, cores, alive, grid, AZURE_PRIORS, d_points=24)
    kernels = _kernels_of_one_call(call)
    assert len(kernels) == 1, kernels
    assert f"{which}_kernel" in kernels[0] and "BeliefRow" in kernels[0], \
        kernels


def test_card_run_is_deterministic_and_conserves(card):
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    K.reset_launches()
    (m1, a1), (m2, a2) = run(1, policy), run(1, policy)
    assert K.LAUNCHES == {"moment_curves_belief": 2 * cfg.n_steps,
                          "moment_curves_agg_belief": 2 * cfg.n_steps // 3,
                          "moment_curves_packed": 0,
                          "moment_curves_agg_packed": 0}
    assert torch.equal(a1, a2)
    for x, y in zip(m1, m2):
        assert torch.equal(x, y)
    assert float(m1.alive_end) == float(
        m1.arrivals_accepted - m1.slot_overflow - m1.n_departed)
    assert 0.0 < float(m1.utilization) <= 1.0


def _card_engine_case(card, telemetry):
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3,
                      telemetry=telemetry)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    return cfg, grid, make_policy(SECOND, rho=0.05, capacity=cfg.capacity)


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
def test_card_engine_equals_make_run(card, telemetry):
    """The online engine on the card, driven by make_run's generator and
    stream, takes make_run's decisions and gives its metrics (and rider)
    bit for bit, with one row launch a tick and one aggregate a refresh."""
    from repro_torch.serve import OnlineAdmissionEngine
    from repro_torch.sim import draw_arrival_stream
    from repro_torch.sim.simulator import _steps

    cfg, grid, policy = _card_engine_case(card, telemetry)
    want = make_run(cfg, grid, SECOND, record_decisions=True,
                    device=card)(1, policy)
    gen = torch.Generator(device=card).manual_seed(1)
    stream = draw_arrival_stream(gen, cfg)
    n_arr = stream.n_arrivals.cpu().numpy()
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy, device=card)
    K.reset_launches()
    accept = []
    for t, slice_t in enumerate(_steps(stream)):
        eng.tick(gen=gen)
        accept.append(eng.decide_slice(slice_t, np.arange(4) < n_arr[t]))
    assert K.LAUNCHES["moment_curves_belief"] == cfg.n_steps
    assert K.LAUNCHES["moment_curves_agg_belief"] == cfg.n_steps // 3
    np.testing.assert_array_equal(np.stack(accept), want[1].cpu().numpy())
    for x, y in zip(eng.metrics(), want[0]):
        assert torch.equal(x, y)
    if telemetry:
        for x, y in zip(eng._cs.tel, want[2]):
            assert torch.equal(x, y)


def test_card_engine_pump_launches_on_the_engine_stream(card):
    """A pump thread's flushes launch the kernels on the stream the engine
    was built on (here a side stream; the thread starts on the default
    one): the naive lane's aggregate takes that stream's barrier slot."""
    from repro_torch.serve import Arrival, OnlineAdmissionEngine

    cfg, grid, policy = _card_engine_case(card, True)
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy, naive=True,
                                    micro_batch=4, device=card)
    eng.tick(gen=torch.Generator(device=card).manual_seed(0))
    host_gen = torch.Generator().manual_seed(7)
    K.reset_launches()
    eng.start(interval_s=0.001)
    try:
        futs = [eng.submit(Arrival.draw(host_gen, cfg)) for _ in range(6)]
        assert all(isinstance(f.result(timeout=60), bool) for f in futs)
    finally:
        eng.stop()
    assert K.LAUNCHES["moment_curves_agg_belief"] == 6
    assert K.LAUNCHES["moment_curves_belief"] == 6
    assert (card.index or 0, side.cuda_stream) in K._BARRIER_SLOTS
    assert eng.metrics_snapshot()["telemetry"]["n_routed"] == 6


@pytest.mark.parametrize("runs,d,n", [(1, 96, 12), (3, 8193, 48),
                                      (24, 8192, 48), (24, 300, 12)])
def test_batched_aggregate_matches_plain_and_one_run_launches(card, runs, d,
                                                              n):
    """The batched aggregate against its plain version (the moment-curve
    tolerances), equal bit for bit run by run to one-run launches, and equal
    in 20 replays of a CUDA graph of a call."""
    bel, cores, alive, grid = _case(d, n, 24, card, runs)
    t, idx, frac, nd = ops.curve_grid(grid, 24)
    args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
    before = K.LAUNCHES["moment_curves_agg_belief"]
    el, vl = K.moment_curves_agg_belief(*args)
    assert K.LAUNCHES["moment_curves_agg_belief"] == before + 1
    want_el, want_vl = R.moment_curves_agg_belief_ref(*args)
    torch.testing.assert_close(el, want_el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(vl, want_vl, rtol=2e-3, atol=1e-4)
    for r in range(runs):
        one = K.moment_curves_agg_belief(GammaBelief(*(x[r] for x in bel)),
                                         cores[r], alive[r], t, idx, frac,
                                         nd, AZURE_PRIORS)
        assert torch.equal(one[0], el[r]) and torch.equal(one[1], vl[r])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.moment_curves_agg_belief(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = K.moment_curves_agg_belief(*args)
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], el) and torch.equal(got[1], vl)


def test_batched_aggregate_is_one_kernel(card):
    """R runs' aggregates are one launch of the aggregate kernel and
    nothing else, through the ``ops`` entry point."""
    bel, cores, alive, grid = _case(8192, 48, 24, card, runs=24)
    kernels = _kernels_of_one_call(lambda: ops.aggregate_moment_curves_kernel(
        bel, cores, alive, grid, AZURE_PRIORS, d_points=24))
    assert len(kernels) == 1, kernels
    assert "agg_kernel" in kernels[0] and "BeliefRow" in kernels[0], kernels


def test_card_batch_equals_single_runs(card):
    """A batch on the card: run r has the bits of the run alone, and the
    batch launches one candidate kernel a step and one aggregate a refresh
    (over all its runs)."""
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    seeds, rhos = [3, 1, 4, 1], [0.05, 0.01, 0.2, 0.3]
    K.reset_launches()
    metrics, accept = run(seeds, make_policy(SECOND, rho=rhos,
                                             capacity=cfg.capacity))
    assert K.LAUNCHES["moment_curves_belief"] == cfg.n_steps
    assert K.LAUNCHES["moment_curves_agg_belief"] == cfg.n_steps // 3
    for r, (seed, rho) in enumerate(zip(seeds, rhos)):
        one, one_accept = run(seed, make_policy(SECOND, rho=rho,
                                                capacity=cfg.capacity))
        assert torch.equal(accept[r], one_accept)
        for name in one._fields:
            assert torch.equal(getattr(metrics, name)[r], getattr(one, name))


def test_card_fleet_of_one_equals_make_run(card):
    """A fleet of one on the card takes ``make_run``'s decisions and metrics
    bit for bit on the same seed."""
    from repro_torch.core import fleet_policy
    from repro_torch.sim import FleetConfig, make_fleet_run

    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    m1, acc1 = make_run(cfg, grid, SECOND, record_decisions=True,
                        device=card)(7, make_policy(SECOND, rho=0.05,
                                                    capacity=cfg.capacity))
    fleet = FleetConfig(base=cfg, capacities=(cfg.capacity,))
    mf, accf, _ = make_fleet_run(fleet, grid, SECOND, record_decisions=True,
                                 device=card)(7, fleet_policy(
                                     SECOND, capacities=(cfg.capacity,),
                                     rho=0.05))
    assert torch.equal(accf[:, 0], acc1)
    for name in m1._fields:
        got = getattr(mf.per_cluster, name)
        assert torch.equal(got[..., 0, :] if got.ndim > 1 else got[0],
                           getattr(m1, name)), name


def test_card_fleet_refresh_is_one_aggregate_launch(card):
    """A fleet's refresh sums all C clusters' tables (R C for a batch of R
    fleet runs) in one aggregate launch: one CUDA kernel in a graph of the
    refresh, and one launch a refresh over a run; each cluster's sums have
    the bits of a launch on its table alone."""
    from repro_torch.core import fleet_policy
    from repro_torch.sim import FleetConfig, make_admission_core, make_fleet_run

    cfg = make_config(capacity=500.0, arrival_rate=0.2,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    caps = (250.0, 150.0, 100.0)
    run = make_fleet_run(FleetConfig(base=cfg, capacities=caps), grid,
                         SECOND, device=card)
    K.reset_launches()
    run([1, 2], fleet_policy(SECOND, capacities=caps, rho=0.2))
    assert K.LAUNCHES["moment_curves_agg_belief"] == cfg.n_steps // 3
    assert K.LAUNCHES["moment_curves_belief"] == cfg.n_steps
    core = make_admission_core(cfg, grid, SECOND, device=card)
    bel, cores, alive, _ = _case(96, 12, 8, card, runs=6)
    cs = core.init((2, 3))
    cs = cs._replace(slots=cs.slots._replace(
        bel=GammaBelief(*(x.view(2, 3, 96) for x in bel)),
        cores=cores.view(2, 3, 96), alive=alive.view(2, 3, 96)))
    kernels = _kernels_of_one_call(lambda: core.refresh_aggregates(cs))
    assert len(kernels) == 1 and "agg_kernel" in kernels[0], kernels
    out = core.refresh_aggregates(cs)
    for r in range(2):
        for c in range(3):
            one = core.refresh_aggregates(core.init()._replace(
                slots=core.init().slots._replace(
                    bel=GammaBelief(*(x.view(2, 3, 96)[r, c] for x in bel)),
                    cores=cores.view(2, 3, 96)[r, c],
                    alive=alive.view(2, 3, 96)[r, c])))
            assert torch.equal(one.agg_el, out.agg_el[r, c])
            assert torch.equal(one.agg_vl, out.agg_vl[r, c])


@pytest.mark.parametrize("runs,d", [(1, 4096), (4, 300)])
def test_chunked_aggregate_matches_plain_and_narrow_launches(card, runs, d):
    """The aggregate at ``paper_cascade``'s ~2,700 points, in chunks of 256:
    against its plain version at the moment-curve tolerances, and each
    chunk's columns bit for bit those of a launch over at most 256 points
    that holds them (the whole grid's checkpoint spacing)."""
    from repro_torch.core import paper_cascade

    bel, cores, alive, _ = _case(d, 12, 24, card, runs=runs)
    grid = paper_cascade(device=card)
    n = grid.shape[0]
    t, idx, frac, nd = ops.curve_grid(grid, 24)
    args = (bel, cores, alive, t, idx, frac, nd, AZURE_PRIORS)
    before = K.LAUNCHES["moment_curves_agg_belief"]
    el, vl = K.moment_curves_agg_belief(*args)
    assert K.LAUNCHES["moment_curves_agg_belief"] == before + len(
        K.agg_chunks(n))
    assert el.shape[-1] == n
    want_el, want_vl = R.moment_curves_agg_belief_ref(*args)
    torch.testing.assert_close(el, want_el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(vl, want_vl, rtol=2e-3, atol=1e-4)
    for a, b in [(0, 100), (250, 300), (n - 37, n), (1000, 1256)]:
        part = K._agg_belief_launch(bel, cores, alive, t[a:b], idx[a:b],
                                    frac[a:b], t, nd, AZURE_PRIORS)
        assert torch.equal(part[0], el[..., a:b])
        assert torch.equal(part[1], vl[..., a:b])


@pytest.mark.parametrize("prior_mode, n_obs", [("pseudo", 50),
                                                ("labeled", 5),
                                                ("unlabeled", 5)])
def test_card_batch_equals_single_runs_in_prior_modes(card, prior_mode,
                                                      n_obs):
    """The §6/§7 modes on the card, with Def. 4's heuristic: run r of a
    batch has the bits of the run alone, and the unlabeled mode launches
    one candidate kernel a step for both mixture components."""
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3,
                      prior_mode=prior_mode, n_pseudo_obs=n_obs)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    seeds, rhos = [3, 1, 4], [0.05, 0.01, 0.2]
    K.reset_launches()
    metrics, accept = run(seeds, make_policy(SECOND, rho=rhos,
                                             capacity=cfg.capacity,
                                             marginal=True))
    assert K.LAUNCHES["moment_curves_belief"] == cfg.n_steps
    assert K.LAUNCHES["moment_curves_agg_belief"] == cfg.n_steps // 3
    for r, (seed, rho) in enumerate(zip(seeds, rhos)):
        one, one_accept = run(seed, make_policy(SECOND, rho=rho,
                                                capacity=cfg.capacity,
                                                marginal=True))
        assert torch.equal(accept[r], one_accept)
        for name in one._fields:
            assert torch.equal(getattr(metrics, name)[r], getattr(one, name))


def test_unlabeled_rows_in_one_launch_equal_two(card):
    """Both mixture components' rows in one row-kernel launch give the bits
    of one launch a component, and match the plain version on beliefs after
    50 pseudo observations."""
    from repro_torch.core import (apply_pseudo_observations,
                                  belief_from_prior, sample_params,
                                  sample_pseudo_observations)

    gen = torch.Generator(device=card).manual_seed(17)
    t, idx, frac, nd = ops.curve_grid(geometric_grid(6.0, 78_840.0, 48,
                                                     device=card), 24)
    bels = []
    for k in (50, 5):
        params = sample_params(gen, AZURE_PRIORS, (192,), device=card)
        bels.append(apply_pseudo_observations(
            belief_from_prior(AZURE_PRIORS, (192,), device=card),
            sample_pseudo_observations(gen, params, AZURE_PRIORS, k),
            AZURE_PRIORS))
    cores = 1.0 + torch.poisson(torch.full((192,), 4.0, device=card),
                                generator=gen)
    both = GammaBelief(*(torch.cat(xs) for xs in zip(*bels)))
    args = (t, idx, frac, nd, AZURE_PRIORS)
    one = K.moment_curves_belief(both, torch.cat([cores, cores]), *args)
    two = [K.moment_curves_belief(b, cores, *args) for b in bels]
    for i in range(2):
        assert torch.equal(one[i], torch.cat([two[0][i], two[1][i]]))
    el, vl = R.moment_curves_belief_ref(both, torch.cat([cores, cores]),
                                        *args)
    torch.testing.assert_close(one[0], el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(one[1], vl, rtol=2e-3, atol=1e-4)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("s,h,kvh,dh", [
    (100, 8, 2, 64), (256, 4, 1, 128), (1000, 32, 8, 64),
    # the families' G = 5 (Dh 64 and 128), 6, 12 and 48
    (300, 25, 5, 64), (300, 40, 8, 128), (300, 48, 8, 128),
    (300, 24, 2, 128), (300, 48, 1, 128)])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=2e-5, atol=2e-5)),
    # one bf16 ulp (2^-7 of the value) of the float32 result rounded
    (torch.bfloat16, dict(rtol=8e-3, atol=1e-5))])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_kernel_matches_plain_version(card, s, h, kvh, dh, dtype, tol,
                                            window):
    gen = torch.Generator(device=card).manual_seed(s + h)
    q = _randn(gen, (2, s, h, dh), dtype, card)
    k = _randn(gen, (2, s, kvh, dh), dtype, card)
    v = _randn(gen, (2, s, kvh, dh), dtype, card)
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention_bshd(q, k, v, causal=True, window=window)
    again = FA.flash_attention_bshd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(got, again)
    want = FR.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype == torch.bfloat16:
        # the kernel keeps p in float32: its outputs are the rounded float32
        # result but for under 1%, where rounding p to bf16 moves over 10%
        rounded = FR.flash_attention_ref(q, k, v, causal=True, window=window,
                                         p_dtype=torch.bfloat16)
        assert float((got != want).float().mean()) <= 0.01
        assert float((rounded != want).float().mean()) > 0.1


# around the bf16 kernel's tiles: 64 keys; 192 / G query positions at
# Dh = 64 and 128 / G at Dh = 128 (G = 1, 4, 8)
FLASH_EDGE_S = [1, 15, 16, 17, 23, 24, 25, 31, 32, 33, 47, 48, 49, 63, 64,
                65, 127, 128, 129, 191, 192, 193, 1000]


@pytest.mark.parametrize("s", FLASH_EDGE_S)
@pytest.mark.parametrize("h,kvh,dh", [(4, 4, 64), (8, 2, 64), (16, 2, 64),
                                      (4, 4, 128), (8, 2, 128),
                                      (16, 2, 128)])
@pytest.mark.parametrize("window", [0, 40])
def test_flash_bf16_kernel_at_tile_edges(card, s, h, kvh, dh, window):
    gen = torch.Generator(device=card).manual_seed(s * 7 + h + dh)
    q = _randn(gen, (1, s, h, dh), torch.bfloat16, card)
    k = _randn(gen, (1, s, kvh, dh), torch.bfloat16, card)
    v = _randn(gen, (1, s, kvh, dh), torch.bfloat16, card)
    got = FA.flash_attention_bshd(q, k, v, causal=True, window=window)
    again = FA.flash_attention_bshd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = FR.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-5)


@pytest.mark.parametrize("h,kvh,dh", [(32, 8, 64), (16, 2, 128)])
def test_flash_bf16_reads_fused_qkv_views(card, h, kvh, dh):
    """q, k and v as strided views of one [B, S, H + 2 KVH, Dh] tensor, as a
    fused QKV projection hands them over: the same bits as from contiguous
    copies."""
    gen = torch.Generator(device=card).manual_seed(h + dh)
    qkv = _randn(gen, (2, 300, h + 2 * kvh, dh), torch.bfloat16, card)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    got = FA.flash_attention_bshd(q, k, v, causal=True)
    copies = FA.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True)
    assert torch.equal(got, copies)
    want = FR.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-5)


def test_flash_bf16_refuses_misaligned_views(card):
    gen = torch.Generator(device=card).manual_seed(3)
    x = _randn(gen, (1, 64, 8, 72), torch.bfloat16, card)
    k = _randn(gen, (1, 64, 2, 64), torch.bfloat16, card)
    before = FA.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_bshd(x[..., 1:65], k, k, causal=True)
    odd = _randn(gen, (1, 64, 8, 65), torch.bfloat16, card)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_bshd(odd, k, k, causal=True)
    assert FA.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("s,h,kvh,dh", [
    (77, 32, 8, 64), (2048, 8, 1, 128),
    # G = 1, 2, 8 and 16, Dh = 256
    (1500, 8, 8, 64), (1500, 16, 8, 128), (1500, 32, 4, 64),
    (3000, 16, 1, 64), (1200, 8, 2, 256),
    # the families' G = 5 (Dh 64 and 128), 6, 12 and 48
    (1500, 25, 5, 64), (1500, 40, 8, 128), (1500, 48, 8, 128),
    (1500, 24, 2, 128), (1500, 48, 1, 128)])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(card, s, h, kvh, dh, kv_dtype):
    gen = torch.Generator(device=card).manual_seed(s + h)
    q = _randn(gen, (4, h, dh), torch.bfloat16, card)
    k = _randn(gen, (4, s, kvh, dh), kv_dtype, card)
    v = _randn(gen, (4, s, kvh, dh), kv_dtype, card)
    tile = DR.key_tile(k.element_size(), dh)
    assert DG._library().dg_key_tile(k.element_size(), dh) == tile
    share = DG.N_SPLITS * tile
    length_sets = [[0, 1, s // 2, s],
                   # one under, at and one over a tile and a split's share
                   [min(n, s) for n in (tile - 1, tile, tile + 1, share + 1)],
                   [min(n, s) for n in (share - 1, share, s - 1, 2)]]
    for lengths in length_sets:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=card)
        before = DG.LAUNCHES["decode_gqa"]
        got = DG.decode_gqa_bshd(q, k, v, lengths)
        again = DG.decode_gqa_bshd(q, k, v, lengths)
        torch.cuda.synchronize()
        assert DG.LAUNCHES["decode_gqa"] == before + 2
        assert torch.equal(got, again)
        for row, n in enumerate(lengths.tolist()):
            if n == 0:
                assert torch.equal(got[row], torch.zeros_like(got[row]))
        # float32 outputs computed from the same inputs for either cache
        want = DR.decode_gqa_ref(q, k, v, lengths)
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
        torch.testing.assert_close(
            DR.decode_gqa_split_ref(q, k, v, lengths, DG.N_SPLITS), want,
            rtol=3e-5, atol=3e-5)


def test_decode_refuses_misaligned_views(card):
    gen = torch.Generator(device=card).manual_seed(4)
    q = _randn(gen, (2, 8, 64), torch.bfloat16, card)
    wide = _randn(gen, (2, 128, 2, 72), torch.bfloat16, card)
    k = _randn(gen, (2, 128, 2, 64), torch.bfloat16, card)
    lengths = torch.tensor([5, 128], dtype=torch.int32, device=card)
    before = DG.LAUNCHES["decode_gqa"]
    with pytest.raises(ValueError, match="16-byte"):
        DG.decode_gqa_bshd(q, wide[..., 1:65], k, lengths)
    odd = _randn(gen, (2, 128, 2, 65), torch.bfloat16, card)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        DG.decode_gqa_bshd(q, k, odd, lengths)
    assert DG.LAUNCHES["decode_gqa"] == before
    # an aligned view of the wider cache is read in place
    view = wide[..., :64]
    torch.testing.assert_close(
        DG.decode_gqa_bshd(q, view, view, lengths),
        DR.decode_gqa_ref(q, view, view, lengths), rtol=3e-5, atol=3e-5)


def _kernels_of_one_call(call):
    """The CUDA kernels one ``call()`` launches, counted from a CUDA graph
    of the call (``repro_torch.kernels._graph``): each kernel node by its
    function's name, any other node (a memset, a copy) as ``<type node>``."""
    names, others = kernels_of_one_call(call)
    return names + [f"<{kind} node>" for kind in others]


def test_decode_call_is_one_kernel(card):
    """A call launches one CUDA kernel and nothing else (no combine kernel,
    no scratch)."""
    gen = torch.Generator(device=card).manual_seed(5)
    q = _randn(gen, (4, 32, 64), torch.bfloat16, card)
    k = _randn(gen, (4, 1024, 8, 64), torch.bfloat16, card)
    lengths = torch.tensor([1024, 7, 0, 512], dtype=torch.int32, device=card)
    kernels = _kernels_of_one_call(
        lambda: DG.decode_gqa_bshd(q, k, k, lengths))
    assert len(kernels) == 1 and "decode_cluster_kernel" in kernels[0], \
        kernels


def test_small_lm_on_card_matches_cpu(card):
    """llama3.2-1b's heads (32 over 8, head_dim 64) at 2 layers and a small
    vocabulary, float32, no TF32: the flash-lane forward and a few decode
    steps on the card against the same model on the CPU."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=2,
                              vocab=512, dtype=torch.float32,
                              use_flash_kernel=True)
    model = DecoderLM(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = model.init(torch.Generator().manual_seed(0), device=card)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 96)))
    before = FA.LAUNCHES["flash_attention"]
    got = model.forward(p_card, tokens.to(card))
    assert FA.LAUNCHES["flash_attention"] == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), model.forward(p_cpu, tokens),
                               rtol=1e-4, atol=1e-4)
    caches = {d: model.init_cache(2, 16, dtype=torch.float32, device=d)
              for d in ("cpu", card)}
    for t in range(8):
        out = {}
        for d, p in (("cpu", p_cpu), (card, p_card)):
            out[d], caches[d] = model.decode_step(p, tokens[:, t].to(d),
                                                  caches[d])
        torch.testing.assert_close(out[card].cpu(), out["cpu"], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES
                                  if n != "llama3.2-1b"])
def test_each_family_on_card_matches_cpu(card, name):
    """Each other architecture's reduced config (2 layers, d_model 64,
    float32, no TF32) with head_dim 64, which the flash kernel takes: the
    forward with the flash lane, and decode steps with the decode kernel,
    on the card against the same model on the CPU."""
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(get_config(name)), head_dim=64,
                              use_flash_kernel=True)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = model.init(torch.Generator().manual_seed(0), device=card)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    extra = {}
    if cfg.family == "audio":
        extra = {"frames": torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    before = FA.LAUNCHES["flash_attention"]
    got = model.forward(p_card, tokens.to(card),
                        **{k: v.to(card) for k, v in extra.items()})
    attn = sum(t in ("attn", "hybrid")
               for t in getattr(model, "layer_types", ()))
    assert FA.LAUNCHES["flash_attention"] == before + attn
    torch.testing.assert_close(got.cpu(), model.forward(p_cpu, tokens,
                                                        **extra),
                               rtol=1e-4, atol=1e-4)
    caches = {d: model.init_cache(2, 24, dtype=torch.float32, device=d)
              for d in ("cpu", card)}
    before = DG.LAUNCHES["decode_gqa"]
    for t in range(20):
        out = {}
        for d, p in (("cpu", p_cpu), (card, p_card)):
            out[d], caches[d] = model.decode_step(
                p, tokens[:, t].to(d), caches[d], use_kernel=True)
        torch.testing.assert_close(out[card].cpu(), out["cpu"], rtol=1e-4,
                                   atol=1e-4)
    decoders = (cfg.n_layers if cfg.family == "audio"
                else sum(t in ("attn", "hybrid") for t in model.layer_types))
    assert DG.LAUNCHES["decode_gqa"] == before + 20 * decoders


@pytest.mark.parametrize("name", ["llama3.2-1b", "chameleon-34b",
                                  "dbrx-132b", "hymba-1.5b", "xlstm-125m",
                                  "whisper-small"])
def test_train_step_on_card_matches_cpu(card, name):
    """One train step (loss, gradients, AdamW) of each family's reduced
    config, float32, no TF32, on the card against the same state and batch
    on the CPU: loss and grad_norm at 1e-4, and the flash kernel never
    launched (training takes the einsum lanes)."""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(get_config(name))
    model = build_model(cfg)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=8))
    audio = cfg.family == "audio"
    batch = make_batch(PipelineConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4,
        frames_dim=cfg.d_model if audio else 0,
        enc_seq=cfg.enc_seq if audio else 0), 0)
    before = FA.LAUNCHES["flash_attention"]
    metrics = {}
    for d in ("cpu", card):
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 device=d)
        _, metrics[d] = step(state, {k: torch.from_numpy(v).to(d)
                                     for k, v in batch.items()})
    assert FA.LAUNCHES["flash_attention"] == before
    for key in ("loss", "grad_norm"):
        assert np.isfinite(float(metrics["cpu"][key]))
        torch.testing.assert_close(metrics[card][key].cpu(),
                                   metrics["cpu"][key], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the trace-driven path on the card
# ---------------------------------------------------------------------------

def _trace_cfg():
    return make_config(capacity=400.0, arrival_rate=0.3,
                       horizon_hours=60 * 24.0, dt=6.0, max_slots=128,
                       max_arrivals=16, d_points=8)


def _trace(device):
    from repro_torch.traces import TraceSpec, synthesize_scenario

    spec = TraceSpec(horizon_hours=60 * 24.0, arrival_rate=0.3,
                     max_deployments=1024, max_events=8)
    return synthesize_scenario(3, "batched", spec, device=device)


def _lam_b_rtol(bel):
    """rtol 2e-6 plus 4 float32 ulps of each term of log E[mu^nu] =
    lgamma(a + nu) - lgamma(a) - nu log b (``tests/test_torch_priors.py``'s
    bound for two lgamma implementations)."""
    a, b = (x.double().cpu() for x in (bel.mu_a, bel.mu_b))
    nu = AZURE_PRIORS.nu
    scale = (torch.lgamma(a + nu).abs() + torch.lgamma(a).abs()
             + (nu * torch.log(b)).abs())
    return 2e-6 + 4 * 2.0**-23 * scale


def test_replay_stream_on_card_equals_cpu(card):
    """GLOBAL replay is exact on either device; PSEUDO-observed too but
    for ``lam_b``, which adds E[mu^nu] through each device's lgammaf (held
    to ``_lam_b_rtol``)."""
    from repro_torch.sim import PSEUDO
    from repro_torch.traces import trace_to, trace_to_stream

    trace = _trace("cpu")
    cfg = _trace_cfg()
    for c in (cfg, cfg._replace(prior_mode=PSEUDO, n_pseudo_obs=1)):
        got, g_drop = trace_to_stream(trace_to(trace, card), c,
                                      pseudo_source="observed")
        want, w_drop = trace_to_stream(trace, c, pseudo_source="observed")
        assert int(g_drop) == int(w_drop)
        for part in ("params", "c0", "n_arrivals", "bel", "bel_alt"):
            g, w = getattr(got, part), getattr(want, part)
            for name, x, y in zip(getattr(g, "_fields", (part,)),
                                  g if isinstance(g, tuple) else (g,),
                                  w if isinstance(w, tuple) else (w,)):
                if name == "lam_b" and c.prior_mode == PSEUDO:
                    rel = (x.cpu().double() - y.double()).abs() / y.abs()
                    assert bool((rel <= _lam_b_rtol(g)).all()), part
                else:
                    assert torch.equal(x.cpu(), y), (part, name)


def test_replayed_batch_on_card_equals_runs_alone(card):
    from repro_torch.traces import TraceArrivalSource

    cfg = _trace_cfg()
    source = TraceArrivalSource(_trace(card))
    run = make_run(cfg, geometric_grid(6.0, 3 * cfg.horizon_hours, 12,
                                       device=card), SECOND,
                   arrival_source=source, device=card)
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    batch = run([1, 2, 1], policy)
    for r, seed in enumerate([1, 2, 1]):
        alone = run(seed, policy)
        for name in alone._fields:
            assert torch.equal(getattr(batch, name)[r],
                               getattr(alone, name)), (seed, name)


def test_probe_stream_on_card_is_the_run_stream(card):
    from repro_torch.sim import PriorArrivalSource
    from repro_torch.sim import importance as PI

    class Recording(PriorArrivalSource):
        def stream(self, gen, cfg):
            self.seen = super().stream(gen, cfg)
            return self.seen

    cfg = _trace_cfg()._replace(max_arrivals=8)
    grid = geometric_grid(6.0, 3 * cfg.horizon_hours, 12, device=card)
    src = Recording()
    make_run(cfg, grid, SECOND, arrival_source=src, device=card)(
        77, make_policy(SECOND, rho=0.05, capacity=cfg.capacity))
    probe = PI._probe_streams([77], cfg, card, None)
    leaves = lambda t: [y for x in t for y in (
        x if isinstance(x, tuple) else (x,))]
    for x, y in zip(leaves(probe), leaves(src.seen)):
        assert torch.equal(x[0], y)
    bm = PI.badness_measure(77, cfg, grid, device=card)
    assert np.isfinite(bm) and bm > 0


# ---------------------------------------------------------------------------
# the mesh on one card: logical devices [cuda:0] * 4
# ---------------------------------------------------------------------------

def _drive_card_engine(card, cfg, grid, policy, shards):
    from repro_torch.serve import OnlineAdmissionEngine
    from repro_torch.sim import draw_arrival_stream
    from repro_torch.sim.simulator import _steps

    gen = torch.Generator(device=card).manual_seed(1)
    stream = draw_arrival_stream(gen, cfg)
    n_arr = stream.n_arrivals.cpu().numpy()
    eng = OnlineAdmissionEngine(cfg, grid, SECOND, policy, shards=shards,
                                device=card)
    refreshed, refresh = [], eng.core.refresh_aggregates

    def recording(cs):
        cs = refresh(cs)
        refreshed.append(torch.stack([cs.agg_el, cs.agg_vl]).clone())
        return cs

    eng.core = eng.core._replace(refresh_aggregates=recording)
    accept = []
    for t, slice_t in enumerate(_steps(stream)):
        eng.tick(gen=gen)
        accept.append(eng.decide_slice(slice_t, np.arange(4) < n_arr[t]))
    return np.stack(accept), refreshed, eng.metrics(), eng._cs.tel


def test_card_sharded_engine_equals_unsharded(card, monkeypatch):
    """The slot table over 4 logical devices of the card (the fused lane,
    which the sharded refresh mirrors; the rider on): decisions, every
    refreshed aggregate, metrics and rider equal the unsharded engine's bit
    for bit, with one row launch a tick on the mesh's first device."""
    monkeypatch.setenv("REPRO_TORCH_DEVICE_COUNT", "4")
    cfg, grid, policy = _card_engine_case(card, True)
    cfg = cfg._replace(agg_backend="fused")
    want = _drive_card_engine(card, cfg, grid, policy, None)
    K.reset_launches()
    got = _drive_card_engine(card, cfg, grid, policy, 4)
    assert K.LAUNCHES["moment_curves_belief"] == cfg.n_steps
    assert K.LAUNCHES["moment_curves_agg_belief"] == 0
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == cfg.n_steps // 3
    for x, y in zip(got[1], want[1]):
        assert torch.equal(x, y)
    for a, b in zip(got[2:], want[2:]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_card_split_batch_and_calibration_equal_one_device(card):
    """A ragged batch of 6 runs split over 4 logical devices of the card
    (padded to 8), and a 3 x 3 calibration grid over them (9 runs padded to
    12): equal to one device's, bit for bit."""
    from repro_torch.sim import run_keyed_batch
    from repro_torch.tuning import calibrate

    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    seeds = [3, 1, 4, 1, 5, 9]
    policy = make_policy(SECOND, rho=[0.05, 0.01, 0.2, 0.3, 0.1, 0.02],
                         capacity=cfg.capacity)
    want, got = run(seeds, policy), run_keyed_batch(run, seeds, policy,
                                                    devices=[card] * 4)
    assert torch.equal(got[1], want[1])
    for name in want[0]._fields:
        assert torch.equal(getattr(got[0], name), getattr(want[0], name))
    plain = make_run(cfg, grid, SECOND, device=card)
    kw = dict(capacity=cfg.capacity, tau=5e-3, thetas=[0.3, 0.05, 0.01])
    one = calibrate(plain, SECOND, [7, 8, 9], devices=[card], **kw)
    four = calibrate(plain, SECOND, [7, 8, 9], devices=[card] * 4, **kw)
    assert one.theta == four.theta
    np.testing.assert_array_equal(one.stages[0].agg_fail,
                                  four.stages[0].agg_fail)
    np.testing.assert_array_equal(one.stages[0].util, four.stages[0].util)


# the families' (H, KVH, Dh): llama3.2-1b, hymba, qwen3, chameleon and
# dbrx, starcoder2, granite, whisper, moonshot
LSE_HEADS = [(32, 8, 64), (25, 5, 64), (40, 8, 128), (48, 8, 128),
             (24, 2, 128), (48, 1, 128), (12, 12, 64), (16, 16, 128)]


@pytest.mark.parametrize("h,kvh,dh", LSE_HEADS)
def test_decode_kernel_log_sum_exp_matches_plain_version(card, h, kvh, dh):
    """The kernel's optional log-sum-exp at lengths 0, 1, 2,048 and 4,096
    of a 4,096-slot bf16 cache: -inf at length 0, the plain version's
    elsewhere (3e-5); the output keeps the bits of the call without it."""
    gen = torch.Generator(device=card).manual_seed(h + dh)
    q = _randn(gen, (4, h, dh), torch.bfloat16, card)
    k = _randn(gen, (4, 4096, kvh, dh), torch.bfloat16, card)
    v = _randn(gen, (4, 4096, kvh, dh), torch.bfloat16, card)
    lengths = torch.tensor([0, 1, 2048, 4096], dtype=torch.int32,
                           device=card)
    before = dict(DG.LAUNCHES)
    out, lse = DG.decode_gqa_bshd(q, k, v, lengths, return_lse=True)
    plain_out = DG.decode_gqa_bshd(q, k, v, lengths)
    torch.cuda.synchronize()
    assert DG.LAUNCHES["decode_gqa_lse"] == before["decode_gqa_lse"] + 1
    assert DG.LAUNCHES["decode_gqa"] == before["decode_gqa"] + 1
    assert torch.equal(out, plain_out)
    assert lse.shape == (4, h) and bool(torch.isneginf(lse[0]).all())
    want_out, want_lse = DR.decode_gqa_ref(q, k, v, lengths, return_lse=True)
    torch.testing.assert_close(out, want_out, rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_each_family_decode_over_logical_devices_matches_cpu(card, name,
                                                             monkeypatch):
    """Each architecture's reduced config (head_dim 64, float32, no TF32)
    decoding 20 teacher-forced steps over 4 logical devices of the card
    (``launch.mesh.make_host_mesh`` under ``REPRO_TORCH_DEVICE_COUNT=4``),
    its caches laid out by ``cache_shardings``, with the decode kernel's
    log-sum-exp form on each sequence shard: against the unsharded model on
    the CPU at 1e-4."""
    import dataclasses

    from repro_torch.device import DEVICE_COUNT_VAR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.spec import place_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv(DEVICE_COUNT_VAR, "4")
    cfg = dataclasses.replace(reduced_config(get_config(name)), head_dim=64)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    p_card = model.init(torch.Generator().manual_seed(0), device=card)
    mesh = make_host_mesh(card)
    assert mesh.shape == (1, 4)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 20)))
    cache_cpu = model.init_cache(2, 24, dtype=torch.float32, device="cpu")
    cache_card = place_tree(
        model.init_cache(2, 24, dtype=torch.float32, device=card),
        model.cache_shardings(mesh, 2, 24, torch.float32))
    before = DG.LAUNCHES["decode_gqa_lse"]
    for t in range(20):
        want, cache_cpu = model.decode_step(p_cpu, tokens[:, t], cache_cpu,
                                            use_kernel=True)
        got, cache_card = model.decode_step(p_card, tokens[:, t].to(card),
                                            cache_card, mesh,
                                            use_kernel=True)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.cuda.synchronize()
    decoders = (cfg.n_layers if cfg.family == "audio"
                else sum(t in ("attn", "hybrid") for t in model.layer_types))
    assert DG.LAUNCHES["decode_gqa_lse"] == before + 20 * decoders * 4
