"""The port's paged KV cache against ``repro.runtime.paging``: allocator
books, block planning, the in-place pool writes (byte-equal to the
reference's functional ones outside the trash row, whose duplicate-index
scatter is unordered in both), prefix-sharing digests and refcounts; and
``tests/test_paging.py``'s scenarios through both packages —
``ensure_blocks`` (atomic under exhaustion), ``release_sequence``,
``write_prefill`` (the zero-filled pad tail, dead entries clamped to row
0), ``gather_kv`` (equal) and ``paged_decode_attention`` (within the
reference test's 1e-5)."""
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


# ---------------------------------------------------------------------------
# tests/test_paging.py's scenarios through both packages: ensure_blocks,
# release_sequence, write_prefill, gather_kv and paged_decode_attention
# ---------------------------------------------------------------------------
B, P, KV, HD = 3, 4, 2, 8


def _fresh(batch, num_blocks, dtype=np.float32):
    """Empty allocators and caches of both packages, the same geometry."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    return ((jpg.BlockAllocator(num_blocks),
             jpg.init_paged_cache(batch, num_blocks, P, KV, HD, dtype=jdt)),
            (tpg.BlockAllocator(num_blocks),
             tpg.init_paged_cache(batch, num_blocks, P, KV, HD, dtype=tdt,
                                  device="cpu")))


def _ensure(j, t, new_tokens):
    """``ensure_blocks`` in both; the port's updates its state in place."""
    (ja, js), (ta, ts) = j, t
    js = jpg.ensure_blocks(js, ja, new_tokens)
    assert tpg.ensure_blocks(ts, ta, new_tokens) is None
    assert list(ta.free) == list(ja.free)
    _assert_state_equal(ts, js)
    return (ja, js), t


def _write_tokens(n, seed=0):
    """``tests/test_paging.py``'s ``_write_tokens``: one block-ensure and
    one appended token a step for every sequence, in both packages."""
    rng = np.random.default_rng(seed)
    j, t = _fresh(B, 32)
    for _ in range(n):
        j, t = _ensure(j, t, np.ones(B, np.int64))
        k = rng.normal(size=(B, KV, HD)).astype(np.float32)
        v = rng.normal(size=(B, KV, HD)).astype(np.float32)
        j = (j[0], jpg.append_tokens(j[1], jnp.asarray(k), jnp.asarray(v)))
        tpg.append_tokens(t[1], torch.tensor(k), torch.tensor(v))
    _assert_state_equal(t[1], j[1])
    return j, t


def _assert_gather_equal(ts, js, max_len):
    got, want = tpg.gather_kv(ts, max_len), jpg.gather_kv(js, max_len)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    return got


@pytest.mark.parametrize("max_len", [12, 10, 4])
def test_gather_kv_equals_the_reference(max_len):
    (_, js), (_, ts) = _write_tokens(10)
    k, _, valid = _assert_gather_equal(ts, js, max_len)
    n = min(10, max_len)
    assert bool(valid[:, :n].all()) and not bool(valid[:, n:].any())


@pytest.mark.parametrize("gp,max_len", [(2, 12), (1, 16), (4, 9)])
def test_paged_decode_attention_equals_the_reference(gp, max_len):
    (_, js), (_, ts) = _write_tokens(9)
    q = np.random.default_rng(1).normal(size=(B, KV, gp, HD)).astype(
        np.float32)
    got = tpg.paged_decode_attention(torch.tensor(q), ts, max_len)
    want = jpg.paged_decode_attention(jnp.asarray(q), js, max_len)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_paged_decode_attention_of_an_empty_sequence_equals_the_reference():
    """A sequence with no tokens: every score is masked to -1e30 and both
    packages average row 0's values alike."""
    j, t = _write_tokens(5)
    (ja, js), (ta, ts) = j, t
    js = jpg.release_sequence(js, ja, 1)
    tpg.release_sequence(ts, ta, 1)
    q = np.random.default_rng(2).normal(size=(B, KV, 2, HD)).astype(
        np.float32)
    got = tpg.paged_decode_attention(torch.tensor(q), ts, 8)
    want = jpg.paged_decode_attention(jnp.asarray(q), js, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_allocator_reuse_after_release_equals_the_reference():
    j, t = _fresh(2, 8, dtype=ml_dtypes.bfloat16)
    j, t = _ensure(j, t, np.array([P * 3, P * 3]))
    assert t[0].available == 2
    js = jpg.release_sequence(j[1], j[0], 0)
    assert tpg.release_sequence(t[1], t[0], 0) is None
    assert list(t[0].free) == list(j[0].free) and t[0].available == 5
    _assert_state_equal(t[1], js)
    assert int(t[1].lengths[0]) == 0
    j, t = _ensure((j[0], js), t, np.array([0, P * 4]))
    assert t[0].available == 4


@pytest.mark.parametrize("batch,num_blocks,first,second", [
    (1, 2, None, [P * 3]),                  # tests/test_paging.py's first
    (2, 3, [P, 0], [P * 2, P * 3]),         # 1 + 3 more needed, 2 left
    (2, 4, [P * 2, P], [P * 5, P]),         # wider than a table row
])
def test_exhaustion_is_typed_atomic_and_equal(batch, num_blocks, first,
                                              second):
    j, t = _fresh(batch, num_blocks)
    if first is not None:
        j, t = _ensure(j, t, np.array(first))
    before = (list(t[0].free), t[1].block_table.clone())
    with pytest.raises(jpg.OutOfBlocksError, match="exhausted"):
        jpg.ensure_blocks(j[1], j[0], np.array(second))
    with pytest.raises(tpg.OutOfBlocksError, match="exhausted"):
        tpg.ensure_blocks(t[1], t[0], np.array(second))
    # nothing leaked, not even a satisfiable share
    assert list(t[0].free) == before[0] == list(j[0].free)
    assert torch.equal(t[1].block_table, before[1])
    _assert_state_equal(t[1], j[1])


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("s", [7, 8, 1])
def test_write_prefill_equals_the_reference(dtype, s):
    j, t = _fresh(2, 8, dtype=dtype)
    j, t = _ensure(j, t, np.array([s, 0]))
    rng = np.random.default_rng(5)
    k = rng.normal(size=(s, KV, HD)).astype(np.float32)
    v = rng.normal(size=(s, KV, HD)).astype(np.float32)
    js = jpg.write_prefill(j[1], jnp.asarray(k), jnp.asarray(v), 0)
    assert tpg.write_prefill(t[1], torch.tensor(k), torch.tensor(v),
                             0) is None
    _assert_state_equal(t[1], js)
    assert t[1].lengths.tolist() == [s, 0]
    gk, gv, valid = _assert_gather_equal(t[1], js, 8)
    np.testing.assert_array_equal(gk[0, :s].float().numpy(),
                                  k.astype(dtype).astype(np.float32))
    assert bool(valid[0, :s].all()) and not bool(valid[0, s:].any())


def test_write_prefill_clamps_dead_table_entries_to_row_zero():
    """A sequence whose row owns no block pastes into row 0 (here the
    block sequence 0 owns), in both."""
    j, t = _fresh(2, 8)
    j, t = _ensure(j, t, np.array([P, 0]))
    k = np.random.default_rng(6).normal(size=(P, KV, HD)).astype(
        np.float32)
    js = jpg.write_prefill(j[1], jnp.asarray(k), jnp.asarray(-k), 1)
    tpg.write_prefill(t[1], torch.tensor(k), torch.tensor(-k), 1)
    _assert_state_equal(t[1], js)
    assert t[1].block_table[0, 0] == 0
    np.testing.assert_array_equal(t[1].k_pool[0].numpy(), k)
