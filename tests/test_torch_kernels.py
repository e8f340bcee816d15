"""The port's kernels.  On the CPU: each plain version against the
reference's Pallas kernel (interpret mode) and its XLA twin or oracle (the
CPU tests of the wkv recurrence are in ``test_torch_rwkv.py``, of the
selective scan in ``test_torch_mamba.py``, of the row-wise quantization in
``test_torch_dense_decode.py``).  On a CUDA card
(marker ``cuda``, skipped elsewhere): each CUDA kernel against its plain
version, and the launch counts.  The card has no JAX, so the reference is
imported only by the tests that use it; there, run

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels.py
"""
import collections
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant as rq
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels import wkv as wk

RNG = np.random.default_rng(23)

# f32 tolerance for the algorithm: the same online softmax, summed in
# another order (einsum vs dot, multiply by 1/sqrt(hd) vs divide)
F32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernels (absent where the card is)."""
    jnp = pytest.importorskip("jax.numpy")
    import ml_dtypes
    from repro.kernels import ops, ref
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.int8_matmul import int8_matmul_pallas
    from repro.kernels.paged_attention import paged_attention_pallas
    return types.SimpleNamespace(
        jnp=jnp, ops=ops, ref=ref, bf16=ml_dtypes.bfloat16,
        int8_matmul_pallas=int8_matmul_pallas,
        flash_attention_pallas=flash_attention_pallas,
        paged_attention_pallas=paged_attention_pallas)


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------
def _int8(shape):
    return RNG.integers(-127, 128, shape, dtype=np.int8)


def test_int8_plain_equals_pallas_kernel_interpreted(jx):
    x, w = _int8((128, 256)), _int8((256, 128))     # one Pallas block
    ref = jx.int8_matmul_pallas(jx.jnp.asarray(x), jx.jnp.asarray(w),
                                interpret=True)
    got = im.int8_matmul_plain(torch.tensor(x), torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("m,k,n", [(200, 300, 130), (8, 1024, 8), (1, 5, 3),
                                   (384, 128, 512)])
def test_int8_plain_equals_oracle(jx, m, k, n):
    x, w = _int8((m, k)), _int8((k, n))
    ref = jx.ref.int8_matmul_ref(jx.jnp.asarray(x), jx.jnp.asarray(w))
    before = im.int8_matmul.launches
    got = im.int8_matmul(torch.tensor(x), torch.tensor(w))   # CPU: plain
    assert im.int8_matmul.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_int8_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        im.int8_matmul(torch.zeros(2, 4), torch.zeros(4, 3, dtype=torch.int8))
    with pytest.raises(ValueError):
        im.int8_matmul(torch.zeros(2, 4, dtype=torch.int8),
                       torch.zeros(5, 3, dtype=torch.int8))


def _check_plan(m, k, n, sms):
    """``int8_matmul.plan``: the tile by M, every K tile in exactly one
    split, splits no shorter than ``LEAST_K_STEPS`` (or all of K), at most
    ``MAX_SPLITS`` of a 64- or 128-row tile, and a grid that fills the card
    and stays within one wave of ``BLOCKS_PER_SM`` blocks per SM, unless
    the tiles alone exceed it, K is too short to split further or the
    splits are at their cap."""
    p = im.plan(m, k, n, sms)
    assert p.bm == (16 if m <= 16 else 64 if m <= 64 else 128)
    assert (p.bn, p.bk) == ((im.DECODE_BN, im.DECODE_BK) if m <= 16
                            else (im.TILE_BN, im.TILE_BK))
    tiles = -(-n // p.bn) * -(-m // p.bm)
    k_tiles = -(-k // p.bk)
    cap = k_tiles if m <= 16 else min(k_tiles, im.MAX_SPLITS)
    assert 1 <= p.splits <= cap
    assert (p.splits - 1) * p.per < k_tiles <= p.splits * p.per
    least = min(k_tiles, im.LEAST_K_STEPS)
    assert p.per >= least
    assert tiles * p.splits <= max(tiles, im.BLOCKS_PER_SM * sms)
    assert tiles * p.splits >= sms or p.per == least \
        or p.splits == im.MAX_SPLITS and m > 16 \
        or p.splits == 1 and tiles >= sms // im.BLOCKS_PER_SM
    return p, tiles * p.splits


@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (8, 17408, 5120),
                                   (256, 5120, 17408), (3, 7, 2)])
def test_k_splits_fill_the_card_and_cover_k(m, k, n):
    _check_plan(m, k, n, 132)


# (K, N) of the int8 GEMMs on the main paths: a Qwen3-14B layer, an RWKV-6
# 3B layer, a Jamba-v0.1 attention, Mamba and MLP layer
MAIN_PATH_KN = [(5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120),
                (2560, 2560), (2560, 8960), (8960, 2560),
                (4096, 4096), (4096, 1024), (4096, 16384), (8192, 4096),
                (8192, 288), (256, 8192), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("m", [1, 8, 16, 256, 1024])
@pytest.mark.parametrize("k,n", MAIN_PATH_KN)
def test_int8_plan_fills_the_card_at_main_path_shapes(m, k, n):
    p, blocks = _check_plan(m, k, n, 132)
    if blocks < 132:
        # only a K too short to split, or the split cap, leaves SMs idle
        assert p.per == min(-(-k // p.bk), im.LEAST_K_STEPS) \
            or m > 16 and p.splits == im.MAX_SPLITS


# (M, K, N) of the pose example's int8 heads at its batch of 32
# (``examples_torch/pose_estimation_mpai.py``): fc 64 -> 128, then
# head_loc and head_ori 128 -> 3 and 4; K one and two 64-byte steps and N
# far below a 128-column tile
POSE_EXAMPLE_GEMMS = [(32, 64, 128), (32, 128, 3), (32, 128, 4)]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("m,k,n", [(15, 33, 17), (17, 4096, 1024),
                                   (64, 100, 300), (65, 17408, 5120),
                                   *POSE_EXAMPLE_GEMMS])
def test_int8_plan_covers_k_at_ragged_shapes(m, k, n, sms):
    _check_plan(m, k, n, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (256, 5120, 5120),
                                   (1, 5, 3), (33, 67, 65), (8, 17408, 512),
                                   *POSE_EXAMPLE_GEMMS])
def test_int8_kernel_equals_plain_on_card(cuda, m, k, n):
    x = torch.tensor(_int8((m, k)), device=cuda)
    w = torch.tensor(_int8((k, n)), device=cuda)
    before = im.int8_matmul.launches
    got = im.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
    assert torch.equal(got, im.int8_matmul_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 15, 16, 17, 256, 1024])
@pytest.mark.parametrize("k,n", [(5120, 1024),      # aligned, split K
                                 (1000, 520),       # K % 16 = 8, K % 32 = 8
                                 (77, 131),         # K and N odd
                                 (4100, 2049)])     # K % 32 = 4, N odd
def test_int8_kernel_is_exact_at_tile_edges_on_card(cuda, m, k, n):
    x = torch.tensor(_int8((m, k)), device=cuda)
    w = torch.tensor(_int8((k, n)), device=cuda)
    before = im.int8_matmul.launches
    got = im.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
    assert torch.equal(got, im.int8_matmul_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("sx,sw", [(127, 127), (127, -127), (-127, -127)])
def test_int8_kernel_is_exact_at_the_largest_sums_on_card(cuda, m, sx, sw):
    # K 17408 (Qwen3's MLP down projection): 127 * 127 * 17408 is the
    # largest int32 sum on the main path
    k, n = 17408, 1040
    x = torch.full((m, k), sx, dtype=torch.int8, device=cuda)
    w = torch.full((k, n), sw, dtype=torch.int8, device=cuda)
    got = im.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full((m, n), sx * sw * k,
                                       dtype=torch.int32, device=cuda))
    assert torch.equal(got, im.int8_matmul_plain(x, w))


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------
def _paged_case(lengths, page, kv, gp, hd=16, num_blocks=32,
                pool_dtype=np.float32):
    """Random pools, a shuffled block allocation per sequence, -1 for dead
    entries, and a NaN trash row (any read of it poisons the output)."""
    b = len(lengths)
    mb = max(1, -(-max(lengths) // page))
    free = list(RNG.permutation(num_blocks))
    table = -np.ones((b, mb), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-n // page)):
            table[i, j] = free.pop()
    shape = (num_blocks + 1, page, kv, hd)
    k_pool = RNG.normal(size=shape).astype(np.float32)
    v_pool = RNG.normal(size=shape).astype(np.float32)
    k_pool[-1] = v_pool[-1] = np.nan
    q = RNG.normal(size=(b, kv, gp, hd)).astype(np.float32)
    return (q, k_pool.astype(pool_dtype), v_pool.astype(pool_dtype), table,
            np.asarray(lengths, np.int32))


def _torch_args(case, device="cpu", q_dtype=torch.float32,
                pool_dtype=None):
    q, k, v, t, l = case

    def tt(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    k, v = tt(k), tt(v)
    if pool_dtype is not None:
        k, v = k.to(pool_dtype), v.to(pool_dtype)
    return (tt(q).to(device, q_dtype), k.to(device), v.to(device),
            tt(t).to(device), tt(l).to(device))


CASES = [([9, 1, 6], 4), ([8, 8], 4), ([1, 1, 1, 1], 8), ([33, 7, 20, 15], 8),
         ([6, 0], 4), ([0, 0], 4)]


@pytest.mark.parametrize("lengths,page", CASES)
@pytest.mark.parametrize("kv,gp", [(2, 2), (1, 4), (4, 1)])
def test_paged_plain_matches_pallas_and_xla(jx, lengths, page, kv, gp):
    case = _paged_case(lengths, page, kv, gp)
    jargs = [jx.jnp.asarray(a) for a in case]
    want_pallas = np.asarray(jx.paged_attention_pallas(*jargs,
                                                       interpret=True))
    want_xla = np.asarray(jx.ops.paged_attention_xla(*jargs))
    before = pa.paged_attention.launches
    got = pa.paged_attention(*_torch_args(case)).numpy()     # CPU: plain
    assert pa.paged_attention.launches == before
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_xla, **F32_TOL)
    np.testing.assert_allclose(got, want_pallas, **F32_TOL)
    for i, n in enumerate(lengths):
        if n == 0:                       # nothing to attend to: exactly 0
            np.testing.assert_array_equal(got[i], 0.0)


def test_paged_plain_matches_reference_bf16_pool(jx):
    case = _paged_case([11, 3], 4, 2, 2, pool_dtype=jx.bf16)
    jargs = [jx.jnp.asarray(a) for a in case]
    want = np.asarray(jx.ops.paged_attention_xla(*jargs))
    got = pa.paged_attention(*_torch_args(case)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    want_p = np.asarray(jx.paged_attention_pallas(*jargs, interpret=True))
    np.testing.assert_allclose(got, want_p, **F32_TOL)


def test_paged_wrapper_rejects_mismatched_shapes():
    q, k, v, t, l = _torch_args(_paged_case([5, 2], 4, 2, 2))
    with pytest.raises(ValueError):
        pa.paged_attention(q[:, :1], k, v, t, l)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,page", CASES + [
    ([0, 1, 16, 17, 40, 77, 127, 128], 16),     # a Qwen3-14B decode step
    ([4096] * 8, 16), ([4096], 16),             # long contexts, B 8 and 1
    ([1, 4095, 2048, 4096, 17, 0, 3000, 100], 16)])
@pytest.mark.parametrize("kv,gp,hd", [(2, 2, 16), (8, 5, 128), (1, 16, 64)])
def test_paged_kernel_matches_plain_on_card(cuda, lengths, page, kv, gp, hd):
    blocks = sum(-(-n // page) for n in lengths)
    case = _paged_case(lengths, page, kv, gp, hd=hd,
                       num_blocks=max(80, blocks + 3))
    args = _torch_args(case, cuda, torch.bfloat16, torch.bfloat16)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = pa.paged_attention_plain(*args)
    assert torch.isfinite(got).all()         # never reads the NaN trash row
    # f32 sums in two orders, rounded to bf16: a bf16 ulp or two apart
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2 ** -10)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


def _check_paged_plan(b, kvp, mb, sms):
    """``paged_attention.plan``: every table column in exactly one split,
    splits no shorter than ``LEAST_COLS`` (or the whole table), at most
    ``MAX_SPLITS``, and no more blocks than one wave of ``BLOCKS_PER_SM`` a
    SM needs, unless one split a pair already exceeds it."""
    p = pa.plan(b, kvp, mb, sms)
    owner = [z for z in range(p.splits) for c in range(p.cols)
             if z * p.cols + c < mb]
    assert len(owner) == mb                      # each column exactly once
    assert sorted(set(owner)) == list(range(p.splits))   # no empty split
    assert 1 <= p.splits <= pa.MAX_SPLITS
    assert p.cols >= min(pa.LEAST_COLS, mb)
    assert p.splits <= max(1, pa.BLOCKS_PER_SM * sms // (b * kvp))
    return p, b * kvp * p.splits


@pytest.mark.parametrize("b,kvp,mb", [(8, 8, 8),       # Qwen3-14B decode
                                      (8, 8, 256),     # 4096 tokens each
                                      (1, 8, 256), (1, 8, 8), (64, 8, 8),
                                      (3, 2, 9), (2, 1, 1)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_paged_plan_covers_the_table_once(b, kvp, mb, sms):
    _check_paged_plan(b, kvp, mb, sms)


@pytest.mark.parametrize("b,kvp,mb", [(8, 8, 8), (8, 8, 256)])
def test_paged_plan_fills_the_card_at_main_path_shapes(b, kvp, mb):
    # the Qwen3-14B decode layer and its 4096-token contexts on the H100's
    # 132 SMs: one wave of blocks or more, unless one more split would cut
    # the splits below LEAST_COLS columns or past MAX_SPLITS
    p, blocks = _check_paged_plan(b, kvp, mb, 132)
    assert (blocks >= 132 or p.splits == pa.MAX_SPLITS
            or -(-mb // (p.splits + 1)) < min(pa.LEAST_COLS, mb))


def _split_combine(q, k_pool, v_pool, table, lengths, splits, cols):
    """The kernel's arithmetic in f32 on the CPU: each split's online
    softmax over its own columns in the log2 domain, its partial (m, l,
    acc), and the combine of the live splits in split order."""
    b, kvp, gp, hd = q.shape
    page = k_pool.shape[1]
    qf = q.float() / torch.sqrt(torch.tensor(float(hd)))
    out = torch.zeros((b, kvp, gp, hd))
    log2e = 1.4426950408889634
    for i in range(b):
        n = min(int(lengths[i]), table.shape[1] * page)
        live = -(-n // (cols * page))
        parts = []
        for z in range(splits):
            t0, t1 = z * cols * page, min((z + 1) * cols * page, n)
            if t1 <= t0:                       # wholly past the length
                assert z >= live
                continue
            t = torch.arange(t0, t1)
            rows = table[i, t // page].long()
            assert (rows >= 0).all()           # never a dead entry
            k = k_pool[rows, t % page].float()     # [T, KVp, hd]
            v = v_pool[rows, t % page].float()
            s = torch.einsum("kgd,tkd->kgt", qf[i], k) * log2e
            m = s.amax(-1)
            p = torch.exp2(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v)))
        assert len(parts) == live
        if not parts:
            continue                           # lengths == 0: exactly 0
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        l_all = torch.zeros_like(mx)
        acc = torch.zeros((kvp, gp, hd))
        for m, l, a in parts:                  # in split order
            wgt = torch.exp2(m - mx)
            l_all = l_all + l * wgt
            acc = acc + a * wgt[..., None]
        out[i] = acc / l_all.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("lengths,page", CASES)
@pytest.mark.parametrize("kv,gp", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("cols", [1, 2, 3])
def test_paged_split_and_combine_equals_plain(lengths, page, kv, gp, cols):
    q, k, v, t, l = _torch_args(_paged_case(lengths, page, kv, gp))
    splits = -(-t.shape[1] // cols)
    got = _split_combine(q, k, v, t, l, splits, cols)
    want = pa.paged_attention_plain(q, k, v, t, l)
    torch.testing.assert_close(got, want, **F32_TOL)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[0, 1, 77, 128],        # one split
                                     [0, 3, 700, 4096]])     # 16 splits
@pytest.mark.parametrize("hd", [8, 32, 100, 256])
@pytest.mark.parametrize("aligned", [True, False])
def test_paged_kernel_takes_every_head_dim_and_alignment_on_card(
        cuda, lengths, hd, aligned):
    # every padded head dim (16 to 256: q in registers or in shared memory,
    # a 3- or 2-stage ring), and the 2-byte staging that hd % 8 != 0 and a
    # q off its 16-byte boundary take
    blocks = sum(-(-n // 16) for n in lengths)
    case = _paged_case(lengths, 16, 2, 5, hd=hd, num_blocks=blocks + 3)
    args = _torch_args(case, cuda, torch.bfloat16, torch.bfloat16)
    if not aligned:
        args = (_misaligned(args[0]),) + args[1:]
        assert args[0].data_ptr() % 16
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2 ** -10)
    for i, n in enumerate(lengths):
        if n == 0:
            assert torch.equal(got[i], torch.zeros_like(got[i]))


@pytest.mark.cuda
def test_paged_kernel_refuses_f32(cuda):
    args = _torch_args(_paged_case([5, 2], 4, 2, 2), cuda)
    with pytest.raises(TypeError):
        pa.paged_attention(*args)


# ---------------------------------------------------------------------------
# paged_chunk_attention (plain PyTorch in the port, XLA in the reference)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("start,c,page,length", [(0, 8, 4, 8), (8, 8, 4, 16),
                                                 (16, 8, 8, 24)])
def test_paged_chunk_attention_matches_xla(jx, start, c, page, length):
    kv, gp, hd, num_blocks = 2, 2, 16, 16
    case = _paged_case([length], page, kv, gp, hd=hd, num_blocks=num_blocks)
    _, k_pool, v_pool, table, _ = case
    table = np.concatenate([table, -np.ones((1, 2), np.int32)], axis=1)
    q = RNG.normal(size=(c, kv, gp, hd)).astype(np.float32)
    qpos = np.arange(start, start + c, dtype=np.int32)
    j = jx.jnp.asarray
    want = np.asarray(jx.ops.paged_chunk_attention_xla(
        j(q), j(k_pool), j(v_pool), j(table[0]), j(qpos)))
    got = tops.paged_chunk_attention(
        torch.tensor(q), torch.tensor(k_pool), torch.tensor(v_pool),
        torch.tensor(table[0]), torch.tensor(qpos)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# flash_attention (causal prefill, grouped-query layout)
# ---------------------------------------------------------------------------
def _flash_case(b, s, kvp, gp, hd):
    q = RNG.normal(size=(b, s, kvp, gp, hd)).astype(np.float32)
    k = RNG.normal(size=(b, s, kvp, hd)).astype(np.float32)
    v = RNG.normal(size=(b, s, kvp, hd)).astype(np.float32)
    return q, k, v


def _fold(q, k, v):
    """Grouped layout -> the reference's folded [B*H, S, hd], kv heads
    repeated (query head kv*gp + g reads kv head kv)."""
    b, s, kvp, gp, hd = q.shape
    fold = lambda t: t.transpose(0, 2, 1, 3).reshape(-1, s, hd)
    return (fold(q.reshape(b, s, kvp * gp, hd)),
            fold(np.repeat(k, gp, axis=2)), fold(np.repeat(v, gp, axis=2)))


@pytest.mark.parametrize("b,s,kvp,gp,hd,block", [
    (2, 16, 2, 2, 16, 8),         # GQA, two q and two kv blocks
    (1, 32, 1, 4, 32, 16),
    (2, 8, 4, 1, 8, 8),           # one query head per kv head
])
def test_flash_plain_matches_pallas_and_oracle(jx, b, s, kvp, gp, hd, block):
    q, k, v = _flash_case(b, s, kvp, gp, hd)
    fq, fk, fv = (jx.jnp.asarray(t) for t in _fold(q, k, v))
    want_pallas = np.asarray(jx.flash_attention_pallas(
        fq, fk, fv, bq=block, bk=block, interpret=True))
    want_ref = np.asarray(jx.ref.flash_attention_ref(fq, fk, fv))
    before = fa.flash_attention.launches
    got = tops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert fa.flash_attention.launches == before           # CPU: plain
    want_ops = np.asarray(jx.ops.flash_attention(   # [B, S, H, hd], GQA
        *(jx.jnp.asarray(t) for t in (q.reshape(b, s, kvp * gp, hd), k, v)),
        bq=block, bk=block))
    np.testing.assert_allclose(got.numpy().reshape(want_ops.shape), want_ops,
                               rtol=1e-5, atol=1e-5)
    got = got.numpy().transpose(0, 2, 3, 1, 4).reshape(-1, s, hd)
    np.testing.assert_allclose(got, want_ref, **F32_TOL)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [1, 37])
def test_flash_plain_matches_oracle_at_ragged_s(jx, s):
    q, k, v = _flash_case(2, s, 2, 3, 16)
    want = np.asarray(jx.ref.flash_attention_ref(
        *(jx.jnp.asarray(t) for t in _fold(q, k, v))))
    got = fa.flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)))
    got = got.numpy().transpose(0, 2, 3, 1, 4).reshape(-1, s, 16)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_plain_is_full_attention_on_causal_positions():
    from repro_torch.models import attention as TA
    q, k, v = (torch.from_numpy(t) for t in _flash_case(2, 9, 2, 2, 16))
    pos = torch.arange(9, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        args = (q.to(dtype), k.to(dtype), v.to(dtype))
        assert torch.equal(fa.flash_attention_plain(*args),
                           TA.full_attention(*args, pos, pos, 0))


def test_attention_apply_takes_flash_unless_the_window_bites(monkeypatch):
    from repro_torch.configs.tiny import TINY
    from repro_torch.models import attention as TA
    calls = []
    real = tops.flash_attention
    monkeypatch.setattr(tops, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    g = torch.Generator().manual_seed(0)
    s = 6
    x = torch.randn((2, s, TINY.d_model), generator=g).bfloat16()
    pos = torch.arange(s, dtype=torch.int32).expand(2, s)
    for window, flash in ((0, True), (s, True), (s - 2, False)):
        cfg = TINY.with_(sliding_window=window)
        p = TA.attention_init(cfg, 1, g, "cpu")
        p = {key: val[0] for key, val in p.items()}
        calls.clear()
        out, _, _ = TA.attention_apply(p, cfg, x, pos)
        assert bool(calls) == flash, window
        assert out.shape == x.shape


def test_flash_wrapper_rejects_mismatched_shapes():
    q, k, v = (torch.from_numpy(t) for t in _flash_case(1, 4, 2, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :3], v)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :1], k, v)


FLASH_CARD_CASES = [(8, 32, 8, 5, 128),     # Qwen3-14B admission round
                    (1, 1, 2, 2, 64),       # S = 1
                    (2, 37, 2, 3, 64),      # ragged S
                    (1, 300, 1, 4, 128),    # many tiles, ragged last tile
                    (2, 33, 4, 1, 16),
                    (1, 64, 1, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kvp,gp,hd", FLASH_CARD_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, b, s, kvp, gp, hd):
    q, k, v = (torch.from_numpy(t).to(cuda, torch.bfloat16)
               for t in _flash_case(b, s, kvp, gp, hd))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    # f32 sums in two orders, rounded to bf16: a bf16 ulp or two apart
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2 ** -10)


FLASH_EDGE_CASES = [(2, 1, 2, 5, 128),       # S = 1
                    (1, 63, 2, 4, 64),        # one ragged key tile
                    (1, 64, 1, 5, 128),       # one whole key tile
                    (2, 65, 1, 1, 256),       # a key tile of one key
                    (1, 65, 2, 4, 16),
                    (1, 2048, 1, 5, 128),     # long prefill, 80 row tiles
                    (1, 2048, 2, 1, 64),
                    (8, 128, 8, 4, 128),      # Jamba's attention prefill
                    (1, 200, 1, 3, 40),       # hd padded to 64
                    (1, 70, 1, 2, 100)]       # hd 100: not 16-byte rows


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,kvp,gp,hd", FLASH_EDGE_CASES)
def test_flash_kernel_is_within_tolerance_at_tile_edges_on_card(
        cuda, b, s, kvp, gp, hd):
    # a 128-row tile spans 128 / gp positions; rows of one position sit
    # in two tiles where gp does not divide 128
    q, k, v = (torch.from_numpy(t).to(cuda, torch.bfloat16)
               for t in _flash_case(b, s, kvp, gp, hd))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -6,
                               atol=2 ** -10)


@pytest.mark.cuda
def test_flash_kernel_f32_and_refusals_on_card(cuda):
    q, k, v = (torch.from_numpy(t).to(cuda)
               for t in _flash_case(2, 45, 2, 3, 32))
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        fa.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.zeros((1, 2, 1, 1, 512), device=cuda)
                             if i == 0 else torch.zeros((1, 2, 1, 512),
                                                        device=cuda)
                             for i in range(3)))


# ---------------------------------------------------------------------------
# wkv (RWKV-6 recurrence; CPU tests of the plain version: test_torch_rwkv.py)
# ---------------------------------------------------------------------------
def _wkv_case(b, s, h, n, device):
    mk = lambda: RNG.normal(size=(b, s, h, n)).astype(np.float32)
    w = np.exp(-np.exp(RNG.normal(size=(b, s, h, n)) - 1)).astype(np.float32)
    u = RNG.normal(size=(h, n)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (mk(), mk(), mk(), w, u)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,n", [(8, 128, 40, 64),   # RWKV-6 3B prefill
                                     (1, 2048, 40, 64),   # a long prompt
                                     (1, 1, 2, 64),       # S = 1
                                     (2, 37, 3, 16),      # ragged S
                                     (1, 50, 2, 128), (2, 21, 3, 8)]
                         + [(2, 70, 3, n) for n in wk.HEAD_SIZES])
def test_wkv_kernel_matches_plain_output_and_state_on_card(cuda, b, s, h, n):
    args = _wkv_case(b, s, h, n, cuda)
    before = wk.wkv.launches
    y, s_fin = wk.wkv(*args)
    torch.cuda.synchronize()
    assert wk.wkv.launches == before + 1
    y_p, s_p = wk.wkv_plain(*args)
    # f32 recurrences, summed in two orders
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, s_p, rtol=1e-4, atol=1e-4)


def _check_wkv_plan(b, h, n, sms):
    """``wkv.plan``: every (b, h, m) state column, and every row n of it, in
    exactly one thread; blocks within ``MAX_THREADS``; float4 row groups
    and whole column groups."""
    p = wk.plan(b, h, n, sms)
    parts, cpb = n // p.npt, n // p.msplit
    assert p.npt in wk.ROWS_PER_THREAD and p.npt <= n
    assert n % p.msplit == 0 and cpb % wk.COLS == 0
    groups = cpb // wk.COLS
    assert groups * parts <= wk.MAX_THREADS
    cells = collections.Counter()
    for z in range(p.msplit):                  # one (b, h): all alike
        for tid in range(groups * parts):
            cg, part = tid % groups, tid // groups
            for i in range(p.npt):
                for j in range(wk.COLS):
                    cells[(part * p.npt + i, z * cpb + wk.COLS * cg + j)] += 1
    assert set(cells) == {(i, j) for i in range(n) for j in range(n)}
    assert set(cells.values()) == {1}
    return p, b * h * p.msplit


@pytest.mark.parametrize("b,h,n", [(8, 40, 64),        # RWKV-6 3B prefill
                                   (1, 40, 64), (3, 2, 8), (1, 2, 128),
                                   (2, 3, 16), (4, 5, 32), (8, 40, 128)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_wkv_plan_covers_every_state_column_once(b, h, n, sms):
    _check_wkv_plan(b, h, n, sms)


def _wkv_compiled():
    """The (N, npt) pairs ``csrc/wkv.cu`` instantiates."""
    src = (build.CSRC / "wkv.cu").read_text()
    return sorted({(int(a), int(b)) for a, b in
                   re.findall(r"REPRO_N\((\d+), (\d+)\)", src)})


def _wkv_heads_for(n, npt, sms):
    """The fewest heads, a power of two, whose plan at B 1 keeps ``npt``
    state rows a thread at head size ``n`` on ``sms`` SMs (None if none up
    to 2**15)."""
    return next((h for h in (2 ** i for i in range(16))
                 if wk.plan(1, h, n, sms).npt == npt), None)


def test_wkv_compiles_every_plan_and_the_plan_reaches_each():
    compiled = _wkv_compiled()
    assert compiled == sorted((n, npt) for n in wk.HEAD_SIZES
                              for npt in wk.ROWS_PER_THREAD if npt <= n)
    for n, npt in compiled:
        assert _wkv_heads_for(n, npt, 132) is not None, (n, npt)


def test_wkv_plan_fills_the_card_at_the_rwkv_shape():
    # the RWKV-6 3B prefill window (B 8, H 40, N 64): one wave of blocks or
    # more on 132 SMs; at B 1 the columns split, down to 4 warps a block
    _, blocks = _check_wkv_plan(8, 40, 64, 132)
    assert blocks >= 132
    p, blocks = _check_wkv_plan(1, 40, 64, 132)
    assert p.msplit > 1 and blocks < 132


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["paged_attention", "wkv",
                                    "selective_scan"])
def test_kernel_is_bit_identical_across_launches_on_card(cuda, kernel):
    if kernel == "wkv":
        args = _wkv_case(8, 128, 40, 64, cuda)
        run = lambda: torch.cat([t.flatten() for t in wk.wkv(*args)])
    elif kernel == "selective_scan":
        args = _scan_case(1, 300, 8192, 16, cuda)
        run = lambda: torch.cat([t.flatten()
                                 for t in ss.selective_scan(*args)])
    else:
        case = _paged_case([0, 1, 16, 17, 40, 77, 127, 4096], 16, 8, 5,
                           hd=128, num_blocks=300)
        args = _torch_args(case, cuda, torch.bfloat16, torch.bfloat16)
        run = lambda: pa.paged_attention(*args)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npt", _wkv_compiled())
def test_wkv_kernel_matches_plain_at_every_compiled_tile_on_card(cuda, n,
                                                                npt):
    sms = build.sm_count(cuda.index)
    h = _wkv_heads_for(n, npt, sms)
    assert wk.plan(1, h, n, sms).npt == npt
    args = _wkv_case(1, 9, h, n, cuda)
    y, s_fin = wk.wkv(*args)
    y_p, s_p = wk.wkv_plain(*args)
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_fin, s_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_wkv_kernel_refuses_what_it_does_not_take(cuda):
    r, k, v, w, u = _wkv_case(1, 4, 2, 64, cuda)
    with pytest.raises(TypeError):
        wk.wkv(r.bfloat16(), k, v, w, u)
    r, k, v, w, u = _wkv_case(1, 4, 2, 24, cuda)
    with pytest.raises(ValueError):
        wk.wkv(r, k, v, w, u)


# ---------------------------------------------------------------------------
# selective scan (Mamba; CPU tests of the plain version: test_torch_mamba.py)
# ---------------------------------------------------------------------------
def _scan_case(b, s, d, n, device):
    x = RNG.normal(size=(b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(RNG.normal(size=(b, s, d)) - 3)).astype(np.float32)
    bm = RNG.normal(size=(b, s, n)).astype(np.float32)
    cm = RNG.normal(size=(b, s, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d, 1))
    dd = np.ones(d, np.float32)
    return [torch.from_numpy(v).to(device) for v in (x, dt, bm, cm, a, dd)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n", [(8, 128, 8192, 16),   # Jamba prefill
                                     (1, 2048, 8192, 16),  # a long prompt
                                     (3, 37, 200, 16),     # ragged S and D
                                     (1, 1, 64, 4), (2, 70, 128, 4),
                                     (2, 33, 96, 64)])
def test_selective_scan_kernel_matches_plain_output_and_state_on_card(
        cuda, b, s, d, n):
    args = _scan_case(b, s, d, n, cuda)
    before = ss.selective_scan.launches
    y, h = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.selective_scan.launches == before + 1
    y_p, h_p = ss.selective_scan_plain(*args)
    # f32 recurrences, exp and fma against exp and einsum
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-4)


def _scan_compiled():
    """The (N, lanes) pairs ``csrc/selective_scan.cu`` instantiates."""
    src = (build.CSRC / "selective_scan.cu").read_text()
    return sorted({(int(a), int(b)) for a, b in
                   re.findall(r"REPRO_N\((\d+), (\d+)\)", src)})


def _scan_dim_for(n, lanes, sms):
    """Channels at B 1 whose plan gives ``lanes`` threads a channel of
    ``n`` states on ``sms`` SMs: just enough threads for the card."""
    return -(-32 * ss.WARPS_PER_SM * sms // lanes)


def test_scan_compiles_every_plan_and_the_plan_reaches_each():
    compiled = _scan_compiled()
    assert compiled == sorted(
        (n, lanes) for n in ss.STATE_SIZES for lanes in ss.LANES
        if lanes <= n and n // lanes <= ss.MAX_STATES)
    for n, lanes in compiled:
        assert ss.plan(1, _scan_dim_for(n, lanes, 132), n, 132) == lanes


@pytest.mark.parametrize("b,dim,n", [(8, 8192, 16),    # Jamba prefill
                                     (1, 8192, 16), (3, 8192, 16),
                                     (1, 1, 4), (2, 96, 64), (8, 200, 32),
                                     (64, 8192, 64)])
@pytest.mark.parametrize("sms", [1, 7, 132])
def test_scan_plan_fills_the_card_within_the_compiled_tiles(b, dim, n, sms):
    lanes = ss.plan(b, dim, n, sms)
    assert (n, lanes) in _scan_compiled()
    # the fewest lanes that fill the card, or as many as the tiles allow
    full = b * dim * lanes >= 32 * ss.WARPS_PER_SM * sms
    assert full or lanes == min(n, ss.LANES[-1])
    assert lanes == max(1, n // ss.MAX_STATES) or \
        b * dim * lanes // 2 < 32 * ss.WARPS_PER_SM * sms


@pytest.mark.cuda
@pytest.mark.parametrize("n,lanes", _scan_compiled())
def test_selective_scan_kernel_matches_plain_at_every_compiled_plan_on_card(
        cuda, n, lanes):
    sms = build.sm_count(cuda.index)
    dim = _scan_dim_for(n, lanes, sms) + 3          # ragged D
    assert ss.plan(1, dim, n, sms) == lanes
    args = _scan_case(1, 41, dim, n, cuda)          # ragged S
    y, h = ss.selective_scan(*args)
    y_p, h_p = ss.selective_scan_plain(*args)
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_selective_scan_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, bm, cm, a, dd = _scan_case(1, 4, 64, 16, cuda)
    with pytest.raises(TypeError):
        ss.selective_scan(x.bfloat16(), dt, bm, cm, a, dd)
    with pytest.raises(ValueError):
        ss.selective_scan(x, dt, bm[:, :3], cm, a, dd)
    x, dt, bm, cm, a, dd = _scan_case(1, 4, 64, 12, cuda)
    with pytest.raises(ValueError):
        ss.selective_scan(x, dt, bm, cm, a, dd)


# ---------------------------------------------------------------------------
# row-wise int8 quantization (CPU tests: test_torch_dense_decode.py)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k", [(64, 128),        # int8 KV decode, k or v
                                 (8192, 128),      # int8 KV prefill window
                                 (37, 96), (1, 5), (3, 1000)])
def test_rowwise_quant_kernel_equals_plain_on_card(cuda, m, k, dtype):
    x = RNG.normal(size=(m, k)) * RNG.uniform(0.01, 30, size=(m, 1))
    x[0] = 0.0                                   # the 1e-8 floor
    x = torch.from_numpy(x.astype(np.float32)).to(cuda, dtype)
    before = rq.rowwise_quant.launches
    q, scale = rq.rowwise_quant(x)
    torch.cuda.synchronize()
    assert rq.rowwise_quant.launches == before + 1
    q_p, s_p = rq.rowwise_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(scale, s_p)


@pytest.mark.parametrize("k", [1, 5, 8, 96, 128, 1000, 2048, 4096, 8200])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_quant_plan_reads_every_vector_of_a_row_once(k, itemsize):
    nbytes = k * itemsize
    for rows in (64, 8192, 16384):
        p = rq.plan(k, itemsize, rows, 132)
        if p.r == 0:    # the scalar path: no whole vectors, or too many
            assert p == rq.SCALAR and (
                nbytes % 8 or nbytes > 16 * 32 * rq.MAX_VECTORS)
            continue
        assert p.vb in (8, 16) and nbytes % p.vb == 0
        assert p.g in (1, 2, 4, 8, 16, 32) and p.r in (1, 2, 4, 8)
        nv = nbytes // p.vb
        seen = collections.Counter(gl + j * p.g for gl in range(p.g)
                                   for j in range(p.r) if gl + j * p.g < nv)
        assert set(seen) == set(range(nv)) and set(seen.values()) == {1}
    # bf16 rows of 128: 8-byte vectors while the rows' lanes fit one wave
    assert rq.plan(128, 2, 8192, 132) == rq.Plan(8, 32, 1)
    assert rq.plan(128, 2, 16384, 132) == rq.Plan(16, 16, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [128, 96])
def test_rowwise_quant_kernel_takes_an_unaligned_row_on_card(cuda, dtype, k):
    # a view 2 bytes (bf16) or 4 bytes (f32) off the 16-byte boundary
    m = 37
    base = torch.from_numpy(RNG.normal(size=m * k + 1).astype(np.float32))
    x = (base * 9).to(cuda, dtype)[1:].view(m, k)
    assert x.data_ptr() % 16
    q, scale = rq.rowwise_quant(x)
    q_p, s_p = rq.rowwise_quant_plain(x)
    assert torch.equal(q, q_p) and torch.equal(scale, s_p)


def _kv_case(b, s, h, hd, t, lead, dtype, device, seed):
    """k, v [b, s, h, hd] and an int8 cache of t slots holding random codes
    and scales; with ``lead``, the cache is super-block 1 of a stack of
    ``lead`` (a view, as the windowed server keeps it)."""
    g = torch.Generator().manual_seed(seed)
    k, v = ((torch.randn((b, s, h, hd), generator=g)
             * torch.rand((b, s, h, 1), generator=g) * 20).to(device, dtype)
            for _ in range(2))
    k[0, 0, 0] = 0                                 # the 1e-8 floor
    stack = (lead or 1,)
    codes = [torch.randint(-127, 128, (*stack, b, t, h, hd), generator=g,
                           dtype=torch.int8).to(device) for _ in range(2)]
    scales = [torch.rand((*stack, b, t, h, 1), generator=g).to(device)
              for _ in range(2)]
    bufs = [c[min(1, stack[0] - 1)] for c in codes + scales]
    return k, v, bufs, codes + scales


# (decode position or None for prefill, s, t, stacked super-blocks)
KV_CARD_CASES = [(5, 1, 160, 0), (200, 1, 160, 0),       # plain, clamped
                 (9, 1, 4, 2), (4, 1, 4, 0),             # ring slots
                 (None, 128, 160, 2),                    # Jamba prefill
                 (None, 8, 4, 0), (None, 4, 4, 2), (None, 3, 7, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [128, 96, 12])
@pytest.mark.parametrize("pos,s,t,lead", KV_CARD_CASES)
def test_int8_kv_write_kernel_equals_plain_on_card(cuda, pos, s, t, lead,
                                                   hd, dtype):
    k, v, bufs, whole = _kv_case(8 if hd == 128 else 3, s, 8 if hd == 128
                                 else 2, hd, t, lead, dtype, cuda, seed=s + t)
    plain = [b_.clone() for b_ in bufs]
    slot = None
    if pos is not None:       # decode_slot: ring under a window, else clamp
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        slot = p % t if t == 4 else p.clamp(max=t - 1)
    kept = [w.clone() for w in whole]
    before = rq.rowwise_quant.launches
    rq.rowwise_quant_into(k, v, *bufs, slot)
    torch.cuda.synchronize()
    assert rq.rowwise_quant.launches == before + 1
    rq.rowwise_quant_into_plain(k, v, *plain, slot)
    for got, want in zip(bufs, plain):
        assert torch.equal(got, want)
    if lead:                  # the other super-block is untouched
        for w, kw in zip(whole, kept):
            assert torch.equal(w[0], kw[0])


@pytest.mark.cuda
def test_int8_kv_write_kernel_refuses_what_it_does_not_take(cuda):
    k, v, bufs, _ = _kv_case(2, 1, 2, 16, 4, 0, torch.bfloat16, cuda, 0)
    slot = torch.tensor(1, dtype=torch.int32, device=cuda)
    kq, vq, ks, vs = bufs
    strided = torch.zeros((2, 4, 16, 2), dtype=torch.int8,
                          device=cuda).transpose(2, 3)   # K not unit stride
    with pytest.raises(ValueError):
        rq.rowwise_quant_into(k, v, strided, strided, ks, vs, slot)
    other = torch.zeros((2, 2, 4, 16), dtype=torch.int8,
                        device=cuda).transpose(1, 2)     # v's layout differs
    with pytest.raises(ValueError):
        rq.rowwise_quant_into(k, v, kq, other, ks, vs, slot)
    with pytest.raises(TypeError):
        rq.rowwise_quant_into(k, v, kq, vq, ks, vs, slot.long())
    with pytest.raises(TypeError):
        rq.rowwise_quant_into(k.half(), v.half(), kq, vq, ks, vs, slot)
    with pytest.raises(TypeError):
        rq.rowwise_quant_into(k, v, kq.float(), vq, ks, vs, slot)
    with pytest.raises(ValueError):
        rq.rowwise_quant_into(k, v, kq, vq, ks, vs, slot.cpu())


@pytest.mark.cuda
def test_rowwise_quant_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        rq.rowwise_quant(torch.zeros((2, 3), dtype=torch.float16,
                                     device=cuda))
    with pytest.raises(ValueError):
        rq.rowwise_quant(torch.zeros((2, 3, 4), device=cuda))
