"""The port's paged KV cache against ``repro.runtime.paging``: allocator
books, block planning, the in-place pool writes (byte-equal to the
reference's functional ones outside the trash row, whose duplicate-index
scatter is unordered in both), prefix-sharing digests and refcounts."""
import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from repro.runtime import paging as jpg
from repro_torch import bridge
from repro_torch.runtime import paging as tpg

from conftest import tiny_dense

RNG = np.random.default_rng(31)


def _books(alloc):
    return list(alloc.free), sorted(alloc.quarantined), alloc.live


@pytest.mark.parametrize("seed", range(4))
def test_allocator_books_equal_under_random_ops(seed):
    rng = np.random.default_rng(seed)
    ja, ta = jpg.BlockAllocator(12), tpg.BlockAllocator(12)
    jfreed, tfreed = [], []
    ja.on_release, ta.on_release = jfreed.append, tfreed.append
    held = []
    for _ in range(200):
        op = rng.integers(3)
        if op == 0:
            try:
                b = ja.alloc()
            except jpg.OutOfBlocksError:
                with pytest.raises(tpg.OutOfBlocksError):
                    ta.alloc()
                continue
            assert ta.alloc() == b
            held.append(b)
        elif op == 1 and held:
            give = [held.pop(int(rng.integers(len(held))))
                    for _ in range(int(rng.integers(1, len(held) + 1)))]
            ja.release(give + [-1])
            ta.release(give + [-1])
        else:
            b = int(rng.integers(12))
            assert ta.quarantine(b) == ja.quarantine(b)
        assert _books(ta) == _books(ja)
    assert tfreed == jfreed


@pytest.mark.parametrize("seed", range(6))
def test_plan_blocks_equal_and_atomic(seed):
    rng = np.random.default_rng(seed)
    ja, ta = jpg.BlockAllocator(10), tpg.BlockAllocator(10)
    table = -np.ones((3, 5), np.int32)
    for _ in range(6):
        need = rng.integers(0, 6, 3)
        try:
            want = jpg.plan_blocks(table, ja, need)
        except jpg.OutOfBlocksError:
            before = _books(ta)
            with pytest.raises(tpg.OutOfBlocksError):
                tpg.plan_blocks(table, ta, need)
            assert _books(ta) == before == _books(ja)   # nothing leaked
            continue
        got = tpg.plan_blocks(table, ta, need)
        np.testing.assert_array_equal(got, want)
        assert _books(ta) == _books(ja)
        table = got
        i = int(rng.integers(3))                        # one row finishes
        ja.release(table[i][table[i] >= 0])
        ta.release(table[i][table[i] >= 0])
        table = table.copy()
        table[i] = -1


def _states(lengths, table, num_blocks=12, page=4, kv=2, hd=8,
            dtype=np.float32):
    shape = (num_blocks + 1, page, kv, hd)
    k = RNG.normal(size=shape).astype(dtype)
    v = RNG.normal(size=shape).astype(dtype)
    tree = {"k": k, "v": v, "t": np.asarray(table, np.int32),
            "l": np.asarray(lengths, np.int32)}
    js = jpg.PagedKVState(*(jnp.asarray(tree[n]) for n in "kvtl"))
    ts = tpg.PagedKVState(*(bridge.to_tensor(tree[n], "cpu")
                            for n in "kvtl"))
    return js, ts


def _assert_state_equal(ts, js):
    """Pools byte-equal outside the trash row; table and lengths equal."""
    for t, j in ((ts.k_pool, js.k_pool), (ts.v_pool, js.v_pool)):
        tb = t[:-1].view(torch.int16 if t.dtype == torch.bfloat16
                         else torch.int32).numpy()
        jb = np.asarray(j[:-1]).view(tb.dtype)
        np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts.block_table.numpy(),
                                  np.asarray(js.block_table))
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_append_tokens_equal_with_inactive_rows(dtype):
    # row 2 has no blocks (an idle slot: its write goes to the trash row)
    table = [[3, 7, -1], [5, -1, -1], [-1, -1, -1], [0, 1, 2]]
    js, ts = _states([3, 0, 0, 9], table, dtype=dtype)
    for _ in range(3):
        k = RNG.normal(size=(4, 2, 8)).astype(np.float32)
        v = RNG.normal(size=(4, 2, 8)).astype(np.float32)
        js = jpg.append_tokens(js, jnp.asarray(k), jnp.asarray(v))
        assert tpg.append_tokens(ts, torch.tensor(k), torch.tensor(v)) is None
        _assert_state_equal(ts, js)
    assert ts.lengths.tolist() == [6, 3, 0, 12]


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("s", [8, 6])
def test_write_prefill_batch_equal(dtype, s):
    table = [[3, 7, -1], [5, 6, -1], [-1, -1, -1], [0, 1, 2]]
    js, ts = _states([0, 5, 0, 0], table, dtype=dtype)
    k = RNG.normal(size=(4, s, 2, 8)).astype(np.float32)
    v = RNG.normal(size=(4, s, 2, 8)).astype(np.float32)
    admit = np.array([True, False, True, True])   # row 2 owns no blocks
    js = jpg.write_prefill_batch(js, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(admit))
    tpg.write_prefill_batch(ts, torch.tensor(k), torch.tensor(v),
                            torch.tensor(admit))
    _assert_state_equal(ts, js)


@pytest.mark.parametrize("start", [0, 4, 8])
def test_write_prefill_chunk_equal(start):
    table = [[3, 7, 9, 2], [5, 6, -1, -1]]
    js, ts = _states([0, 0], table)
    for seq in (0, 1):
        k = RNG.normal(size=(4, 2, 8)).astype(np.float32)
        js = jpg.write_prefill_chunk(js, jnp.asarray(k), jnp.asarray(-k),
                                     seq, start)
        tpg.write_prefill_chunk(ts, torch.tensor(k), torch.tensor(-k), seq,
                                start)
        _assert_state_equal(ts, js)


def test_shared_block_index_digests_and_refcounts_equal():
    tokens = RNG.integers(0, 5000, (6, 4)).astype(np.int32)
    jd = td = jpg.SharedBlockIndex.ROOT
    assert tpg.SharedBlockIndex.ROOT == jd
    jdigests, tdigests = [], []
    for row in tokens:
        jd = jpg.SharedBlockIndex.chain(jd, row)
        td = tpg.SharedBlockIndex.chain(td, row)
        jdigests.append(jd)
        tdigests.append(td)
    assert tdigests == jdigests
    ja, ta = jpg.BlockAllocator(8), tpg.BlockAllocator(8)
    ji, ti = jpg.SharedBlockIndex(ja), tpg.SharedBlockIndex(ta)
    for idx, alloc in ((ji, ja), (ti, ta)):
        blocks = [alloc.alloc() for _ in range(4)]
        for d, b in zip(jdigests, blocks):
            idx.register(d, b)
        idx.register(jdigests[0], 7)              # a raced duplicate
        got = [idx.acquire(d) for d in jdigests[:3]] + [idx.acquire(b"x")]
        assert got == blocks[:3] + [None]
        assert idx.release(blocks + [alloc.alloc(), -1]) == [4]
        idx.release(blocks[:2])
    assert (ti.hits, ti.lookups) == (ji.hits, ji.lookups) == (3, 4)
    assert _books(ta) == _books(ja)


def test_block_digest_store_equal():
    js, ts = jpg.BlockDigestStore(), tpg.BlockDigestStore()
    for st in (js, ts):
        for b in (5, 2, 9, 4):
            st.seal(b, b * 11)
        st.forget(9)
    assert ts.items() == js.items()
    assert [ts.scrub_batch(2) for _ in range(3)] == \
        [js.scrub_batch(2) for _ in range(3)]
    assert ts.get(2) == js.get(2) == 22 and (9 in ts) == (9 in js)


@pytest.mark.parametrize("kw", [dict(mixer="mamba"), dict(sliding_window=8),
                                dict(kv_cache_dtype="int8")],
                         ids=["mamba", "window", "int8-kv"])
def test_paged_decode_cache_rejects_what_the_reference_rejects(kw):
    from repro.models import transformer as JT
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as TT
    cfg = tiny_dense(**kw)
    with pytest.raises(ValueError):
        JT.init_paged_decode_cache(cfg, 2, 8, 4)
    tcfg = ModelConfig(**{f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__})
    with pytest.raises(ValueError):
        TT.init_paged_decode_cache(tcfg, 2, 8, 4, device="cpu")


def _pools(dtype, stacked: bool, num_blocks=7):
    """K and V pools with values spread over every bit (large and negative
    elements too), plain ``[NB+1, P, KVp, hd]`` or stacked ``[3, NB+1,
    ...]``."""
    shape = ((3,) if stacked else ()) + (num_blocks + 1, 4, 2, 8)
    k = (RNG.normal(size=shape) * 1e3).astype(dtype)
    v = (RNG.normal(size=shape) * 1e-3).astype(dtype)
    js = jpg.PagedKVState(jnp.asarray(k), jnp.asarray(v), None, None)
    ts = tpg.PagedKVState(bridge.to_tensor(k, "cpu"),
                          bridge.to_tensor(v, "cpu"), None, None)
    return js, ts


@pytest.mark.parametrize("stacked", [False, True], ids=["plain", "stacked"])
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_checksums_equal_the_reference(dtype, stacked):
    js, ts = _pools(dtype, stacked)
    want = np.asarray(jax.jit(jpg.pool_checksums)(js)).astype(np.int64)
    got = tpg.pool_checksums(ts)
    assert got.dtype == torch.int64 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.array([5, 0, 7, 5, 2], np.int32)
    want = np.asarray(jax.jit(jpg.block_checksums)(js, jnp.asarray(rows)))
    got = tpg.block_checksums(ts, torch.as_tensor(rows))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_every_single_bit_flip_moves_the_checksums(dtype):
    """Each of an element's 16 or 32 bits, flipped alone, moves both sums
    of its block and no other block's (bit 15 of an int16 word is its sign
    bit: the flip is an XOR with -32768)."""
    js, ts = _pools(dtype, stacked=True)
    pool_sums = tpg.pool_checksums(ts)
    block_sums = tpg.block_checksums(ts, torch.arange(8))
    nbits = ts.k_pool.element_size() * 8
    words = ts.v_pool.view(torch.int16 if nbits == 16 else torch.int32)
    coord = (1, 3, 2, 1, 5)
    for bit in range(nbits):
        mask = -(1 << bit) if bit == nbits - 1 else 1 << bit
        words[coord] ^= mask
        moved = tpg.pool_checksums(ts) != pool_sums
        assert moved.tolist() == [b == 3 for b in range(8)], bit
        moved = tpg.block_checksums(ts, torch.arange(8)) != block_sums
        assert moved.tolist() == [b == 3 for b in range(8)], bit
        jflip = np.asarray(ts.v_pool.view(torch.int16 if nbits == 16
                                          else torch.int32)).copy()
        want = np.asarray(jax.jit(jpg.pool_checksums)(js._replace(
            v_pool=jnp.asarray(jflip.view(np.asarray(js.v_pool).dtype)))))
        np.testing.assert_array_equal(tpg.pool_checksums(ts).numpy(),
                                      want.astype(np.int64))
        words[coord] ^= mask                     # undo
    assert torch.equal(tpg.pool_checksums(ts), pool_sums)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 9, 1000])
def test_wire_checksum_equals_the_reference(n):
    payload = RNG.integers(0, 256, n).astype(np.uint8).tobytes()
    assert tpg.wire_checksum(payload) == jpg.wire_checksum(payload)
    if n:
        flipped = bytearray(payload)
        flipped[n // 2] ^= 0x40
        assert tpg.wire_checksum(bytes(flipped)) != tpg.wire_checksum(payload)
