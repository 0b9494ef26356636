"""The port's CUDA kernels, simulator and LM on a card (marked ``cuda``;
skipped where no card is visible). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same card
inputs (moment curves: the JAX package's rtol 2e-4 on EL and 2e-3 on VL;
flash attention 2e-5 in float32 and one bf16 ulp in bf16, with p kept in
float32; GQA decode, float32 out, 3e-5 for either cache type), and repeat
launches must be bitwise equal. The decode kernel is also run at lengths
around its key tile and split share, must refuse a misaligned view, and
must be one CUDA kernel a call. The bf16 flash kernel is also run at sequence
lengths around its tiles, on views of a fused QKV tensor, and must refuse a
view that TMA cannot copy. A small
simulator run on the card must repeat bit for bit and conserve deployments,
and a small LM on the card must match the same LM on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import AZURE_PRIORS, SECOND, geometric_grid, make_policy
from repro_torch.core.belief import GammaBelief
from repro_torch.kernels.moment_curves import kernel as K
from repro_torch.kernels.moment_curves import ops
from repro_torch.kernels.moment_curves import ref as R
from repro_torch.kernels.decode_gqa import kernel as DG
from repro_torch.kernels.decode_gqa import ref as DR
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.models import DecoderLM, get_config
from repro_torch.sim import make_config, make_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _packed(d, n, nd, device):
    rng = np.random.default_rng(d + n + nd)
    e = lambda base: torch.from_numpy(
        (base * np.exp(rng.standard_normal(d))).astype(np.float32))
    bel = GammaBelief(e(0.31), e(0.58), e(0.49), e(0.45), e(0.26), e(0.055))
    cores = torch.from_numpy((1.0 + rng.poisson(5.0, d)).astype(np.float32))
    alive = torch.from_numpy(rng.random(d) < 0.6)
    params = ops._pack(bel, cores, AZURE_PRIORS, alive=alive).to(device)
    return (params, *ops._grids(geometric_grid(6.0, 78_840.0, n,
                                               device=device), nd))


@pytest.mark.parametrize("d,n,nd", [(1, 12, 8), (8, 48, 24), (300, 48, 32),
                                    (8193, 48, 24)])
@pytest.mark.parametrize("which", ["rows", "agg"])
def test_kernel_matches_plain_version(card, which, d, n, nd):
    kern, plain = ((K.moment_curves_packed, R.moment_curves_packed_ref)
                   if which == "rows" else
                   (K.moment_curves_agg_packed,
                    R.moment_curves_agg_packed_ref))
    args = _packed(d, n, nd, card)
    before = dict(K.LAUNCHES)
    el, vl = kern(*args, nd)
    el2, vl2 = kern(*args, nd)
    torch.cuda.synchronize()
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 2
    assert torch.equal(el, el2) and torch.equal(vl, vl2)
    want_el, want_vl = plain(*args, nd)
    torch.testing.assert_close(el, want_el, rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(vl, want_vl, rtol=2e-3, atol=1e-4)


def test_card_run_is_deterministic_and_conserves(card):
    cfg = make_config(capacity=500.0, arrival_rate=0.08,
                      horizon_hours=30 * 24.0, dt=24.0, max_slots=96,
                      max_arrivals=4, d_points=8, agg_refresh_steps=3)
    grid = geometric_grid(24.0, 3 * 30 * 24.0, 12)
    policy = make_policy(SECOND, rho=0.05, capacity=cfg.capacity)
    run = make_run(cfg, grid, SECOND, record_decisions=True, device=card)
    K.reset_launches()
    (m1, a1), (m2, a2) = run(1, policy), run(1, policy)
    assert K.LAUNCHES == {"moment_curves_packed": 2 * cfg.n_steps,
                          "moment_curves_agg_packed": 2 * cfg.n_steps // 3}
    assert torch.equal(a1, a2)
    for x, y in zip(m1, m2):
        assert torch.equal(x, y)
    assert float(m1.alive_end) == float(
        m1.arrivals_accepted - m1.slot_overflow - m1.n_departed)
    assert 0.0 < float(m1.utilization) <= 1.0


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("s,h,kvh,dh", [(100, 8, 2, 64), (256, 4, 1, 128),
                                        (1000, 32, 8, 64)])
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
    (3000, 16, 1, 64), (1200, 8, 2, 256)])
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


def test_decode_call_is_one_kernel(card):
    """A call launches one CUDA kernel and nothing else (no combine kernel,
    no scratch). The profiler's schedule runs the call once as a warm-up
    step, whose trace it discards, then once traced. The traced step's own
    marker (``ProfilerStep*``) is an event on the device too; a trace
    without it recorded nothing of the device, and is taken again (at most
    three traces)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    gen = torch.Generator(device=card).manual_seed(5)
    q = _randn(gen, (4, 32, 64), torch.bfloat16, card)
    k = _randn(gen, (4, 1024, 8, 64), torch.bfloat16, card)
    lengths = torch.tensor([1024, 7, 0, 512], dtype=torch.int32, device=card)
    DG.decode_gqa_bshd(q, k, k, lengths)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                DG.decode_gqa_bshd(q, k, k, lengths)
                torch.cuda.synchronize()
                prof.step()
        device = [e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if any(x.startswith("ProfilerStep") for x in device):
            break
    else:
        pytest.fail("torch.profiler recorded nothing of the device in 3 "
                    "traces")
    kernels = [x for x in device if not x.startswith("ProfilerStep")]
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
