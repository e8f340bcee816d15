"""The port's kernels.  On the CPU: each plain version against the
reference's Pallas kernel (interpret mode) and its XLA twin or oracle.  On
a CUDA card (marker ``cuda``, skipped elsewhere): each CUDA kernel against
its plain version, and the launch counts.  The card has no JAX, so the
reference is imported only by the tests that use it; there, run

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import int8_matmul as im
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as pa

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
    from repro.kernels.int8_matmul import int8_matmul_pallas
    from repro.kernels.paged_attention import paged_attention_pallas
    return types.SimpleNamespace(
        jnp=jnp, ops=ops, ref=ref, bf16=ml_dtypes.bfloat16,
        int8_matmul_pallas=int8_matmul_pallas,
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


@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (8, 17408, 5120),
                                   (256, 5120, 17408), (3, 7, 2)])
def test_k_splits_fill_the_card_and_cover_k(m, k, n):
    sms = 132
    s = im.k_splits(m, k, n, sms)
    tiles = -(-n // im.BN) * -(-m // im.BM)
    k_tiles = -(-k // im.BK)
    per = -(-k_tiles // s)
    assert 1 <= s <= k_tiles and (s - 1) * per < k_tiles <= s * per
    assert s == k_tiles or tiles * s >= im.BLOCKS_PER_SM * sms // 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 5120, 1024), (256, 5120, 5120),
                                   (1, 5, 3), (33, 67, 65), (8, 17408, 512)])
def test_int8_kernel_equals_plain_on_card(cuda, m, k, n):
    x = torch.tensor(_int8((m, k)), device=cuda)
    w = torch.tensor(_int8((k, n)), device=cuda)
    before = im.int8_matmul.launches
    got = im.int8_matmul(x, w)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
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
@pytest.mark.parametrize("lengths,page", CASES + [([0, 1, 16, 17, 40, 77, 127,
                                                    128], 16)])
@pytest.mark.parametrize("kv,gp,hd", [(2, 2, 16), (8, 5, 128), (1, 16, 64)])
def test_paged_kernel_matches_plain_on_card(cuda, lengths, page, kv, gp, hd):
    case = _paged_case(lengths, page, kv, gp, hd=hd, num_blocks=80)
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
