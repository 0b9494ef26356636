"""The plain versions of the port's attention kernels against the JAX
package's Pallas kernels (run with ``interpret=True``, as its own tests run
them on the CPU) and its pure-jnp oracles, on identical numpy-made inputs;
and the port's ``ops`` entry points on the CPU.

Tolerances are the JAX package's own (tests/test_kernels.py): flash
attention 2e-5 in float32 and 2e-2 in bf16, GQA decode 3e-5 and 2e-2
(rtol = atol). bf16 inputs are rounded once and handed to both packages, so
both see the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_gqa.ops import decode_gqa as jax_decode_gqa
from repro.kernels.decode_gqa.ref import decode_gqa_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro_torch.kernels.decode_gqa import kernel as DK
from repro_torch.kernels.decode_gqa import ops as DOPS
from repro_torch.kernels.decode_gqa.ref import (decode_gqa_ref,
                                                decode_gqa_split_ref,
                                                key_tile, split_bounds)
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FOPS
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     split3)
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(rng, dtype, *shapes):
    """numpy normals rounded to ``dtype``: (torch tensors, jax arrays)."""
    ts, js = [], []
    for shape in shapes:
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        t = t.to(getattr(torch, dtype))
        ts.append(t)
        js.append(jnp.asarray(t.float().numpy(), getattr(jnp, dtype)))
    return ts, js


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


# the shapes of tests/test_kernels.py's flash tests, plus a ragged S
FLASH_SHAPES = [(1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 512, 8, 8, 128),
                (2, 384, 4, 1, 128), (2, 200, 4, 2, 64)]


@pytest.mark.parametrize("b,s,h,kvh,dh", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_jax_kernel(b, s, h, kvh, dh, dtype):
    rng = np.random.default_rng(s + h)
    (q, k, v), (jq, jk, jv) = _inputs(rng, dtype, (b, s, h, dh),
                                      (b, s, kvh, dh), (b, s, kvh, dh))
    got = flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    _close(got, jax_flash(jq, jk, jv, causal=True, interpret=True), tol)
    _close(got, jax_attn_ref(jq, jk, jv, causal=True), tol)


@pytest.mark.parametrize("window", [64, 256])
def test_flash_sliding_window(window):
    rng = np.random.default_rng(window)
    (q, k, v), (jq, jk, jv) = _inputs(rng, "float32", (1, 384, 4, 64),
                                      (1, 384, 2, 64), (1, 384, 2, 64))
    got = FOPS.flash_attention(q, k, v, causal=True, window=window)
    _close(got, jax_flash(jq, jk, jv, causal=True, window=window,
                          interpret=True), 2e-5)
    _close(got, jax_attn_ref(jq, jk, jv, causal=True, window=window), 2e-5)


def test_flash_non_causal_matches_and_refuses_ragged_keys():
    rng = np.random.default_rng(3)
    (q, k, v), (jq, jk, jv) = _inputs(rng, "float32", (1, 256, 4, 64),
                                      (1, 256, 2, 64), (1, 256, 2, 64))
    got = FOPS.flash_attention(q, k, v, causal=False)
    _close(got, jax_flash(jq, jk, jv, causal=False, interpret=True), 2e-5)
    # the JAX wrapper refuses non-causal attention over a ragged key length;
    # the port accepts exactly the same inputs
    for sk in (100, 200):
        with pytest.raises(ValueError, match="non-causal"):
            FOPS.flash_attention(q, k[:, :sk], v[:, :sk], causal=False)
        with pytest.raises(ValueError, match="non-causal"):
            jax_flash(jq, jk[:, :sk], jv[:, :sk], causal=False,
                      interpret=True)


def test_flash_launcher_takes_plain_version_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(4)
    (q, k, v), _ = _inputs(rng, "float32", (1, 32, 4, 16), (1, 32, 2, 16),
                           (1, 32, 2, 16))
    before = dict(FK.LAUNCHES)
    out = FK.flash_attention_bshd(q, k, v, causal=True)
    assert FK.LAUNCHES == before        # the plain version launches nothing
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True))
    with pytest.raises(TypeError):
        FK.flash_attention_bshd(q, k.to(torch.bfloat16), v, causal=True)
    with pytest.raises(ValueError):
        FK.flash_attention_bshd(q, k[..., :8], v[..., :8], causal=True)
    with pytest.raises(ValueError):
        FK.flash_attention_bshd(q[:, :, :3], k, v, causal=True)


def test_flash_plain_version_with_p_in_bf16_is_told_apart():
    """The card's check that the bf16 kernel keeps p in float32, on the CPU:
    a float64 evaluation of the same bf16 inputs (p exact) rounds to the
    float32 plain version's bf16 outputs but for under 1%; rounding p to
    bf16 before P.V moves over 10% of them."""
    rng = np.random.default_rng(12)
    (q, k, v), _ = _inputs(rng, "bfloat16", (2, 256, 8, 64), (2, 256, 2, 64),
                           (2, 256, 2, 64))
    want = flash_attention_ref(q, k, v, causal=True)
    exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                causal=True).float().to(torch.bfloat16)
    rounded = flash_attention_ref(q, k, v, causal=True,
                                  p_dtype=torch.bfloat16)
    assert rounded.dtype == torch.bfloat16
    assert float((exact != want).float().mean()) <= 0.01
    assert float((rounded != want).float().mean()) > 0.1


def _split3_values(family):
    rng = np.random.default_rng(13)
    if family == "uniform":
        return rng.random(100_000, dtype=np.float32)
    if family == "edges":
        return np.asarray([0.0, 1.0, 0.5, 1.0 - 2.0 ** -24, 2.0 ** -24,
                           np.float32(1.0 / 3.0)], np.float32)
    if family == "under powers of two":
        powers = np.float32(2.0) ** -np.arange(0, 100, dtype=np.float32)
        return np.nextafter(powers, np.float32(0.0))
    # down to 1e-30: p = exp(s - max) of far-off logits
    return (10.0 ** rng.uniform(-30, 0, 100_000)).astype(np.float32)


@pytest.mark.parametrize("family", ["uniform", "edges",
                                    "under powers of two", "tiny"])
def test_split3_reconstructs_float32_p_bit_for_bit(family):
    """The bf16 kernel's three-term split of p (``ref.split3``): every term
    is a bf16, and hi + mid + lo is the float32 p exactly, which is what
    lets its P.V run as three bf16 products and keep p in float32."""
    p = torch.from_numpy(_split3_values(family))
    hi, mid, lo = split3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # each term is the top 16 bits of what is left: hi those of p itself
    assert torch.equal(hi.view(torch.int16),
                       (p.view(torch.int32) >> 16).to(torch.int16))
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back.view(torch.int32), p.view(torch.int32))
    if family == "uniform":
        # two terms would not do: the third carries bits of most p
        assert float(((hi.float() + mid.float()) != p).float().mean()) > 0.5


def test_flash_tma_alignment_check():
    """The bf16 kernel's TMA copies need 16-byte-aligned addresses and
    strides: views of a fused [B, S, H + 2 KVH, Dh] projection pass, a view
    one element off does not."""
    b, s, h, kvh, dh = 1, 8, 4, 2, 64
    qkv = torch.zeros((b, s, h + 2 * kvh, dh + 8), dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, :h, :dh], qkv[:, :, h:h + kvh, :dh],
               qkv[:, :, h + kvh:, :dh])
    FK.check_tma_alignment(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        FK.check_tma_alignment(qkv[:, :, :h, 1:dh + 1], k, v)
    odd = torch.zeros((b, s, h, dh + 1), dtype=torch.bfloat16)[..., :dh]
    with pytest.raises(ValueError, match="16-byte"):
        FK.check_tma_alignment(odd, k, v)
    # a dimension of extent 1 is never stepped: its stride does not matter
    FK.check_tma_alignment(q[:, :1], k, v)


def test_flash_property_rows_are_convex_combos():
    """max |out| <= max |v| (softmax weights sum to 1), over seeds."""
    for seed in range(5):
        rng = np.random.default_rng(seed)
        (q, k, v), _ = _inputs(rng, "float32", (1, 128, 2, 64),
                               (1, 128, 2, 64), (1, 128, 2, 64))
        out = flash_attention_ref(q, k, v, causal=True)
        assert float(out.abs().max()) <= float(v.abs().max()) + 1e-4


# the shapes of tests/test_kernels.py's decode tests
DECODE_SHAPES = [(1, 128, 4, 4, 64, 128), (2, 300, 8, 4, 64, 250),
                 (1, 2048, 8, 1, 128, 1500), (4, 77, 4, 2, 64, 60)]


@pytest.mark.parametrize("b,s,h,kvh,dh,length", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_version_matches_jax_kernel(b, s, h, kvh, dh, length,
                                                 dtype):
    rng = np.random.default_rng(s + length)
    (q, k, v), (jq, jk, jv) = _inputs(rng, dtype, (b, h, dh),
                                      (b, s, kvh, dh), (b, s, kvh, dh))
    got = DOPS.decode_gqa(q, k, v, length)
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    tol = DECODE_TOL[dtype]
    _close(got, jax_decode_gqa(jq, jk, jv, length, interpret=True), tol)
    _close(got, jax_decode_ref(jq, jk, jv, length), tol)


def test_decode_per_row_lengths():
    rng = np.random.default_rng(7)
    (q, k, v), (jq, jk, jv) = _inputs(rng, "float32", (3, 4, 64),
                                      (3, 256, 2, 64), (3, 256, 2, 64))
    lengths = np.asarray([10, 200, 256], np.int32)
    got = DOPS.decode_gqa(q, k, v, torch.from_numpy(lengths))
    _close(got, jax_decode_gqa(jq, jk, jv, jnp.asarray(lengths),
                               interpret=True), 3e-5)
    # one row at a time gives the same rows
    for i, n in enumerate(lengths):
        row = decode_gqa_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                             torch.tensor([n], dtype=torch.int32))
        torch.testing.assert_close(got[i:i + 1], row, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("length", [1, 17, 100, 255, 256])
def test_decode_padding_invariance(length):
    """Keys at or past the length never affect the output."""
    rng = np.random.default_rng(length)
    (q, k, v), _ = _inputs(rng, "float32", (1, 4, 64), (1, 256, 2, 64),
                           (1, 256, 2, 64))
    out1 = DOPS.decode_gqa(q, k, v, length)
    noise = torch.from_numpy(
        100.0 * rng.standard_normal((1, 256, 2, 64)).astype(np.float32))
    tail = torch.arange(256)[None, :, None, None] >= length
    out2 = DOPS.decode_gqa(q, torch.where(tail, noise, k),
                           torch.where(tail, noise, v), length)
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=1e-6)


def test_decode_length_zero_gives_zeros_like_the_tpu_kernel():
    """A row of length 0 gives zeros, as the TPU kernel does (its pure-jnp
    oracle gives the mean of v there)."""
    rng = np.random.default_rng(9)
    (q, k, v), (jq, jk, jv) = _inputs(rng, "float32", (2, 4, 64),
                                      (2, 128, 2, 64), (2, 128, 2, 64))
    lengths = np.asarray([0, 50], np.int32)
    got = DOPS.decode_gqa(q, k, v, torch.from_numpy(lengths))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = np.asarray(jax_decode_gqa(jq, jk, jv, jnp.asarray(lengths),
                                     interpret=True))
    np.testing.assert_array_equal(want[0], 0.0)
    _close(got[1:], want[1:], 3e-5)


def test_decode_launcher_takes_plain_version_on_cpu_and_checks_inputs():
    rng = np.random.default_rng(5)
    (q, k, v), _ = _inputs(rng, "float32", (2, 4, 16), (2, 8, 2, 16),
                           (2, 8, 2, 16))
    lengths = torch.tensor([3, 8], dtype=torch.int32)
    before = dict(DK.LAUNCHES)
    out = DK.decode_gqa_bshd(q, k, v, lengths)
    assert DK.LAUNCHES == before
    assert torch.equal(out, decode_gqa_ref(q, k, v, lengths))
    with pytest.raises(TypeError):
        DK.decode_gqa_bshd(q, k, v, lengths.long())
    with pytest.raises(TypeError):
        DK.decode_gqa_bshd(q, k, v.to(torch.bfloat16), lengths)
    with pytest.raises(ValueError):
        DK.decode_gqa_bshd(q, k, v, lengths[:1])


def test_decode_key_tile_and_split_bounds():
    """The kernel's key tile: 4 warps x keys a warp instruction covers (32
    over 8 to 32 lanes a key) x 4 pieces a lane (2 keys past 32 pieces a
    row); each split's share is ceil(len / splits) rounded up to it,
    contiguous, in rank order."""
    assert key_tile(2, 64) == 64 and key_tile(4, 64) == 32
    assert key_tile(2, 128) == 32 and key_tile(2, 256) == 16
    assert key_tile(4, 256) == 8 and key_tile(2, 16) == 64
    # llama3.2-1b's timed shape: 2,048 valid keys, 256 a CTA
    assert split_bounds(2048, 8, 128) == [(256 * r, 256 * (r + 1))
                                          for r in range(8)]
    assert split_bounds(100, 8, 128) == [(0, 100)] + [(100, 100)] * 7
    assert split_bounds(0, 16, 64) == [(0, 0)] * 16
    for length in range(0, 700, 7):
        bounds = split_bounds(length, 8, 64)
        assert bounds[0][0] == 0 and bounds[-1][1] == length
        assert all(e0 == b1 for (_, e0), (b1, _) in zip(bounds, bounds[1:]))


# (B, S, H, KVH, Dh, lengths, dtype): empty shares (short rows), lengths
# 0, 1 and S, one under, at and one over a tile and a split's share
SPLIT_CASES = [
    (4, 300, 8, 2, 64, [0, 1, 300, 150], "float32"),
    (4, 1100, 4, 1, 64, [511, 513, 1023, 1025], "bfloat16"),
    (2, 1100, 8, 4, 64, [63, 65], "bfloat16"),
    (1, 70, 4, 4, 128, [64], "float32"),
    (3, 520, 16, 1, 16, [65, 0, 520], "bfloat16"),
]


@pytest.mark.parametrize("n_splits", [8, 16])
@pytest.mark.parametrize("b,s,h,kvh,dh,lengths,dtype", SPLIT_CASES)
def test_decode_split_emulation_matches_ref_and_jax(b, s, h, kvh, dh,
                                                   lengths, dtype, n_splits):
    """The kernel's partition (splits' (m, l, acc) combined in rank order)
    gives the plain version and the JAX Pallas kernel at 3e-5."""
    rng = np.random.default_rng(s + h + n_splits)
    (q, k, v), (jq, jk, jv) = _inputs(rng, dtype, (b, h, dh),
                                      (b, s, kvh, dh), (b, s, kvh, dh))
    lens = np.asarray(lengths, np.int32)
    got = decode_gqa_split_ref(q, k, v, torch.from_numpy(lens), n_splits)
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    torch.testing.assert_close(got, decode_gqa_ref(q, k, v,
                                                   torch.from_numpy(lens)),
                               rtol=3e-5, atol=3e-5)
    want = np.asarray(jax_decode_gqa(jq, jk, jv, jnp.asarray(lens),
                                     interpret=True))
    _close(got, want, 3e-5)
    for row, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[row], torch.zeros_like(got[row]))


def test_decode_split_emulation_over_random_lengths():
    """Over seeds: random per-row lengths (0 to S), 8 or 16 splits and the
    tile of a bf16 or float32 cache; the split emulation gives the plain
    version at 3e-5."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        dtype = ("float32", "bfloat16")[seed % 2]
        (q, k, v), _ = _inputs(rng, dtype, (4, 8, 32), (4, 400, 2, 32),
                               (4, 400, 2, 32))
        lens = torch.from_numpy(rng.integers(0, 401, 4).astype(np.int32))
        n_splits = (8, 16)[seed // 3]
        tile = int(rng.choice([16, 32, 64]))
        got = decode_gqa_split_ref(q, k, v, lens, n_splits, tile)
        torch.testing.assert_close(got, decode_gqa_ref(q, k, v, lens),
                                   rtol=3e-5, atol=3e-5)


def test_decode_alignment_check():
    """The kernel reads K and V rows in 16-byte vectors: a cache and views
    of a wider cache pass, a view one element off, a row stride that is not
    a multiple of 16 bytes and a row of 12 bytes do not."""
    cache = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
    DK.check_alignment(cache, cache)
    DK.check_alignment(cache[:, :, 1:3], cache[:, :8])
    with pytest.raises(ValueError, match="16-byte"):
        DK.check_alignment(cache[..., 1:33], cache)
    odd = torch.zeros((2, 16, 4, 65), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        DK.check_alignment(cache, odd)
    with pytest.raises(ValueError, match="16-byte"):
        DK.check_alignment(torch.zeros((2, 16, 4, 3)), cache)
    # a dimension of extent 1 is never stepped: its stride does not matter
    DK.check_alignment(odd[:1, :1, :1], cache)
