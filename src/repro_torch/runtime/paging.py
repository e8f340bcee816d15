"""Paged KV cache — vLLM-style block-table memory management for serving
(the port of ``repro.runtime.paging``).

KV storage is a shared pool of fixed-size token blocks; each sequence owns
a block table (indices into the pool) that grows on demand and frees on
completion.  A tiny host-side allocator plans the tables; the pools live on
the device.

Layout note: pools carry ``num_blocks + 1`` rows.  The last row is a
*trash row* the allocator never hands out; ``append_tokens`` and the
prefill pastes route writes from batch slots with no allocated blocks into
it, so a fixed-shape batch can ride one scatter without corrupting live
blocks.  Readers never touch it.

The JAX reference returns a new state from every write.  Here the writes
(``ensure_blocks``, ``release_sequence``, ``append_tokens``,
``write_prefill``, ``write_prefill_batch``, ``write_prefill_chunk``) update
the pools, table views and lengths *in place* and return nothing: the
engine's pools are tens of GB at full width and are never copied.

Two readers materialize a sequence's KV from its blocks, as the
reference's test oracles: ``gather_kv`` and ``paged_decode_attention``
(a dense f32 softmax over the gathered KV).  The engine serves with the
paged-attention kernel (``kernels.ops.paged_attention``) instead.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class OutOfBlocksError(RuntimeError):
    """KV block pool exhausted — callers defer admission instead of dying.

    Subclasses RuntimeError so legacy ``except RuntimeError`` sites keep
    working; the serving engine catches this type to hold a request in
    its queue until completions release blocks.
    """


class PagedKVState(NamedTuple):
    k_pool: torch.Tensor      # [num_blocks + 1, P, KVp, hd] (last = trash)
    v_pool: torch.Tensor
    block_table: torch.Tensor  # [B, max_blocks] int32 (-1 = unallocated)
    lengths: torch.Tensor     # [B] int32 tokens written per sequence


class BlockAllocator:
    """Host-side free-list over the shared pool.

    Radiation hardening adds a *quarantine* lane: a block a scrub pass
    found corrupted is pulled out of service (``quarantine``) and never
    re-enters the free list — ``release`` silently skips it, so every
    existing teardown path stays exact without knowing about upsets.
    The accounting invariant is ``free + live + quarantined ==
    num_blocks`` with ``live`` derived, which the property tests pin
    under random op interleavings.  ``on_release`` (optional) fires once
    per block that actually returns to the free list — the serving
    engine hooks it to retire stale integrity digests no matter which
    path (finalize, shared-index refcount, release_sequence) freed the
    block.
    """

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.quarantined: set = set()
        self.on_release = None            # callable(block) | None

    def alloc(self) -> int:
        if not self.free:
            raise OutOfBlocksError("KV block pool exhausted")
        return self.free.pop()

    def release(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            if b < 0 or b in self.quarantined:
                continue
            self.free.append(b)
            if self.on_release is not None:
                self.on_release(b)

    def quarantine(self, block: int) -> bool:
        """Take ``block`` out of service; True if newly quarantined."""
        b = int(block)
        if b < 0 or b in self.quarantined:
            return False
        self.quarantined.add(b)
        if b in self.free:                # upset caught while block idle
            self.free.remove(b)
        return True

    @property
    def available(self) -> int:
        return len(self.free)

    @property
    def live(self) -> int:
        return self.num_blocks - len(self.free) - len(self.quarantined)


def init_paged_cache(batch: int, num_blocks: int, block_size: int,
                     kv_heads: int, head_dim: int,
                     dtype=torch.bfloat16,
                     max_blocks: Optional[int] = None,
                     device="cuda") -> PagedKVState:
    """Pools get one extra trash row (see module docstring).

    ``max_blocks`` bounds the per-sequence table width (defaults to
    ``num_blocks``: any sequence may own the whole pool).  The serving
    engine passes ``ceil(max_len / block_size)`` so the kernel's table
    walk is O(max_len / P), not O(pool size).
    """
    if max_blocks is None:
        max_blocks = num_blocks
    shape = (num_blocks + 1, block_size, kv_heads, head_dim)
    return PagedKVState(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        -torch.ones((batch, max_blocks), dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def plan_blocks(table: np.ndarray, alloc: BlockAllocator,
                need_blocks: np.ndarray) -> np.ndarray:
    """Host step: grow each sequence's table row to ``need_blocks[i]``.

    Atomic: the total block need is checked against the allocator before
    anything is taken, so an :class:`OutOfBlocksError` leaks nothing and
    the caller can simply retry later.  Returns a new table array
    (``table`` itself is not mutated).  Counts are *blocks*, not tokens;
    the serving engine calls this on its host-side table mirror.
    """
    table = np.asarray(table).copy()
    grows = []
    total = 0
    for i, add in enumerate(np.asarray(need_blocks)):
        need, have = int(add), int((table[i] >= 0).sum())
        if need > table.shape[1]:
            raise OutOfBlocksError(
                f"KV block pool exhausted: sequence {i} needs {need} "
                f"blocks > table width {table.shape[1]}")
        if need > have:
            grows.append((i, have, need))
            total += need - have
    if total > alloc.available:
        raise OutOfBlocksError(
            f"KV block pool exhausted: need {total} blocks, "
            f"{alloc.available} available")
    for i, have, need in grows:
        for j in range(have, need):
            table[i, j] = alloc.alloc()
    return table


def ensure_blocks(state: PagedKVState, alloc: BlockAllocator,
                  new_tokens: np.ndarray) -> None:
    """Grow each sequence's table to cover len+new tokens, in place.

    Atomic through :func:`plan_blocks`: an :class:`OutOfBlocksError` is
    raised before any block is taken, and the table is left as it was.
    """
    p = state.k_pool.shape[1]
    lengths = state.lengths.cpu().numpy()
    need = -(-(lengths + np.asarray(new_tokens)) // p)   # blocks, not tokens
    table = plan_blocks(state.block_table.cpu().numpy(), alloc, need)
    state.block_table.copy_(torch.from_numpy(table))


def release_sequence(state: PagedKVState, alloc: BlockAllocator,
                     seq: int) -> None:
    """Hand sequence ``seq``'s blocks back to ``alloc`` (in table order) and
    clear its table row and length, in place."""
    row = state.block_table[seq].cpu().numpy()
    alloc.release(row[row >= 0])
    state.block_table[seq] = -1
    state.lengths[seq] = 0


def append_tokens(state: PagedKVState, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Write one new token per sequence, in place.  k, v: [B, KVp, hd].

    Sequences whose next block is unallocated (inactive slots of a
    fixed-size serving batch) write to the trash row instead and their
    length does not advance — the continuous-batching engine relies on
    this to run one fixed-shape scatter for a partially-occupied batch.
    """
    p = state.k_pool.shape[1]
    trash = state.k_pool.shape[0] - 1
    blk_idx = torch.clamp_max(state.lengths // p,
                              state.block_table.shape[1] - 1)
    blk = torch.gather(state.block_table, 1, blk_idx[:, None].long())[:, 0]
    active = blk >= 0
    blk = torch.where(active, blk, trash).long()
    off = torch.where(active, state.lengths % p, 0).long()
    state.k_pool[blk, off] = k.to(state.k_pool.dtype)
    state.v_pool[blk, off] = v.to(state.v_pool.dtype)
    state.lengths.add_(active.to(state.lengths.dtype))


def write_prefill(state: PagedKVState, k: torch.Tensor, v: torch.Tensor,
                  seq: int) -> None:
    """Paste a prefilled sequence's KV into its blocks in one scatter, in
    place.

    k, v: [S, KVp, hd] — tokens 0..S-1 of sequence ``seq`` (whose table
    row must already cover ceil(S / P) blocks and whose length restarts
    at S).  The pad tail of the last block is zero-filled; it sits past
    ``lengths[seq]`` so every reader masks it off.  Dead table entries are
    clamped to row 0, as the reference clamps them.
    """
    p = state.k_pool.shape[1]
    s = k.shape[0]
    nb = -(-s // p)
    pad = nb * p - s

    def blocked(x):
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(nb, p, *x.shape[1:])
    rows = torch.clamp_min(state.block_table[seq, :nb], 0).long()
    state.k_pool[rows] = blocked(k).to(state.k_pool.dtype)
    state.v_pool[rows] = blocked(v).to(state.v_pool.dtype)
    state.lengths[seq] = s


def write_prefill_batch(state: PagedKVState, k: torch.Tensor,
                        v: torch.Tensor, admit: torch.Tensor) -> None:
    """Paste every admitted slot's prefill KV in one scatter, in place.

    k, v: [B, S, KVp, hd] — the whole prefill batch; ``admit``: [B] bool.
    Non-admitted rows (occupied slots riding along in the fixed-shape
    prefill bucket, or empty slots) scatter into the trash row; admitted
    rows land in their table blocks and restart at length S.  The pad tail
    of a last block is zero-filled; it sits past ``lengths`` so every
    reader masks it off.
    """
    p = state.k_pool.shape[1]
    trash = state.k_pool.shape[0] - 1
    b, s = k.shape[:2]
    nb = -(-s // p)
    pad = nb * p - s

    def blocked(x):
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(b * nb, p, *x.shape[2:])
    rows = state.block_table[:, :nb]
    rows = torch.where(admit[:, None] & (rows >= 0), rows, trash)
    rows = rows.reshape(-1).long()
    state.k_pool[rows] = blocked(k).to(state.k_pool.dtype)
    state.v_pool[rows] = blocked(v).to(state.v_pool.dtype)
    state.lengths.copy_(torch.where(admit, s, state.lengths))


def write_prefill_chunk(state: PagedKVState, k: torch.Tensor,
                        v: torch.Tensor, seq: int, start: int) -> None:
    """Paste one *chunk* of a prefill into sequence ``seq``'s blocks, in
    place.

    k, v: [C, KVp, hd] — tokens ``start .. start+C-1`` of the sequence.
    Both ``start`` and ``C`` must be block-aligned (``% P == 0``), so the
    paste is a whole-block scatter.  The sequence's length advances to
    ``start + C``; callers paste chunks left to right so the final chunk
    leaves the true prefill length behind.  Unallocated table entries
    route to the trash row (same contract as ``append_tokens``).
    """
    p = state.k_pool.shape[1]
    trash = state.k_pool.shape[0] - 1
    c = k.shape[0]
    nb = c // p
    row = state.block_table[seq, start // p:start // p + nb]
    rows = torch.where(row >= 0, row, trash).long()
    state.k_pool[rows] = k.reshape(nb, p, *k.shape[1:]).to(state.k_pool.dtype)
    state.v_pool[rows] = v.reshape(nb, p, *v.shape[1:]).to(state.v_pool.dtype)
    state.lengths[seq] = start + c


def _words(pool: torch.Tensor) -> torch.Tensor:
    """A pool's elements as signed integers of their own width (a view:
    a 16-bit pool as int16, a 32-bit one as int32)."""
    return pool.view(torch.int16 if pool.element_size() == 2
                     else torch.int32)


def _row_sums(words: torch.Tensor, row_axis: int) -> torch.Tensor:
    """Sum every axis but ``row_axis`` (0 or 1) in int64, exactly: the
    trailing axes first, as one contiguous reduction a row (the dtype is
    the reduction's: nothing widened is materialized), then the stack."""
    s = words.flatten(row_axis + 1).sum(-1, dtype=torch.int64)
    return s.sum(0) if row_axis else s


def block_checksums(state: PagedKVState, rows: torch.Tensor) -> torch.Tensor:
    """Integrity checksums for pool rows ``rows``: int64 ``[len(rows)]``
    holding uint32 values.

    Each block's K and V content, read as unsigned integers of its element
    width, summed mod 2**32, so any single-event upset (one flipped bit
    anywhere in the block) changes the checksum.  Works on plain ``[NB+1,
    P, KVp, hd]`` pools and on the engine's sublayer-stacked ``[S, NB+1,
    ...]`` pools; rows index the block axis either way.
    """
    rows = torch.as_tensor(rows, device=state.k_pool.device).long()
    total = None
    for pool in (state.k_pool, state.v_pool):
        x = _words(pool[:, rows] if pool.ndim == 5 else pool[rows])
        if x.dtype == torch.int16:       # widen as unsigned, then sum
            x = x.to(torch.int64) & 0xFFFF
        # 32-bit words: the signed sum equals the unsigned one mod 2**32
        s = _row_sums(x, 1 if pool.ndim == 5 else 0)
        total = s if total is None else total + s
    return total & 0xFFFFFFFF


def pool_checksums(state: PagedKVState) -> torch.Tensor:
    """Integrity checksums for *every* block row of the pool at once
    (trash row included): int64 ``[NB+1]`` holding uint32 values.

    One straight reduction over each pool with no row-index operand — the
    decode hot path's fused verify; the host indexes the result by the
    blocks it holds digests for.  A 16-bit pool sums mod 2**16 before it
    widens (a single-event upset still moves the sum by a nonzero power of
    two), a 32-bit one mod 2**32; K and V add mod 2**32.
    """
    total = None
    for pool in (state.k_pool, state.v_pool):
        s = _row_sums(_words(pool), 1 if pool.ndim == 5 else 0)
        s = s & (0xFFFF if pool.element_size() == 2 else 0xFFFFFFFF)
        total = s if total is None else total + s
    return total & 0xFFFFFFFF


def wire_checksum(payload: bytes) -> int:
    """Integrity checksum for a serialized handoff payload — the host
    sibling of :func:`pool_checksums`: the buffer zero-padded to a word
    boundary, viewed as native-width uint32 words and summed mod 2**32.
    Pure numpy, so a host with no accelerator can verify it."""
    pad = (-len(payload)) % 4
    if pad:
        payload = payload + b"\x00" * pad
    words = np.frombuffer(payload, dtype=np.uint32)
    return int(np.sum(words, dtype=np.uint32))


class BlockDigestStore:
    """Host-side registry of *sealed* block checksums.

    A block is sealed once its content is final — the tail block a
    decode step is still appending into stays out until it fills, so
    digests never churn on the hot path.  ``scrub_batch`` hands back up
    to ``budget`` sealed blocks round-robin for a budgeted verify pass;
    the engine wires ``BlockAllocator.on_release`` to :meth:`forget` so
    a freed block's digest dies with it and a recycled block can never
    false-positive against a stale seal.
    """

    def __init__(self):
        self._sums: Dict[int, int] = {}
        self._cursor = 0

    def seal(self, block: int, checksum: int) -> None:
        self._sums[int(block)] = int(checksum)

    def forget(self, block: int) -> None:
        self._sums.pop(int(block), None)

    def get(self, block: int) -> Optional[int]:
        return self._sums.get(int(block))

    def items(self) -> List[Tuple[int, int]]:
        """Snapshot of (block, sealed checksum) pairs — safe to iterate
        while corruption handling forgets entries mid-walk."""
        return list(self._sums.items())

    def __contains__(self, block: int) -> bool:
        return int(block) in self._sums

    def __len__(self) -> int:
        return len(self._sums)

    def scrub_batch(self, budget: int) -> List[int]:
        """Next ``budget`` sealed blocks to verify (round-robin)."""
        if not self._sums or budget <= 0:
            return []
        keys = sorted(self._sums)
        self._cursor %= len(keys)
        out = [keys[(self._cursor + j) % len(keys)]
               for j in range(min(budget, len(keys)))]
        self._cursor = (self._cursor + len(out)) % len(keys)
        return out


class SharedBlockIndex:
    """Content-hashed prefix-block sharing over one allocator's pool.

    A full block of prompt tokens is identified by the *chain digest* of
    its content: ``sha1(parent_digest + tokens.tobytes())``.  Because the
    digest folds in the whole token prefix, two sequences map to the
    same digest exactly when their prompts agree through that block —
    the condition under which their KV is bit-identical and the block
    can be shared read-only.  The index tracks a refcount per registered
    block: the prefilling owner holds one reference, each sharer adds
    one, and the block returns to the allocator only when the last
    reference releases.  Entries leave the index the moment their
    refcount hits zero, so sharing happens across *concurrently live*
    sequences (a common system prompt across a batch) and the allocator
    accounting stays exact — no unreferenced cache to evict.
    """

    ROOT = b""

    def __init__(self, alloc: BlockAllocator):
        self.alloc = alloc
        self._by_digest: Dict[bytes, int] = {}
        self._digest_of: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self.hits = 0                     # blocks reused instead of refilled
        self.lookups = 0                  # share attempts (hits + misses)

    @staticmethod
    def chain(parent: bytes, tokens: np.ndarray) -> bytes:
        return hashlib.sha1(parent
                            + np.ascontiguousarray(tokens, np.int32)
                            .tobytes()).digest()

    def lookup(self, digest: bytes) -> Optional[int]:
        return self._by_digest.get(digest)

    def acquire(self, digest: bytes) -> Optional[int]:
        """Take a reference on the block holding ``digest``'s KV."""
        self.lookups += 1
        blk = self._by_digest.get(digest)
        if blk is not None:
            self._refs[blk] += 1
            self.hits += 1
        return blk

    def register(self, digest: bytes, block: int) -> None:
        """Publish a freshly prefilled block (owner's reference)."""
        if digest in self._by_digest:     # raced by an identical prompt:
            return                        # keep the first copy canonical
        self._by_digest[digest] = block
        self._digest_of[block] = digest
        self._refs[block] = self._refs.get(block, 0) + 1

    def release(self, blocks: Iterable[int] = ()) -> List[int]:
        """Drop one reference per block; returns the blocks NOT tracked
        here (still owned solely by the caller) so the caller can hand
        them straight back to the allocator.  Tracked blocks go back to
        the allocator automatically when their last reference drops."""
        untracked: List[int] = []
        for b in blocks:
            b = int(b)
            if b < 0:
                continue
            if b not in self._refs:
                untracked.append(b)
                continue
            self._refs[b] -= 1
            if self._refs[b] <= 0:
                del self._refs[b]
                self._by_digest.pop(self._digest_of.pop(b), None)
                self.alloc.release([b])
        return untracked

    def purge(self, block: int) -> None:
        """Evict a corrupted block from the index unconditionally.

        The block is headed for quarantine, not the free list, so all
        outstanding references are dropped at once — future prompts with
        the same prefix re-prefill a fresh copy instead of sharing the
        upset one.  Refcounts cannot leak: the entry is gone, so every
        holder's eventual ``release`` treats the block as untracked and
        the allocator (already holding it in quarantine) skips it.
        """
        b = int(block)
        if b not in self._refs:
            return
        del self._refs[b]
        self._by_digest.pop(self._digest_of.pop(b), None)


def gather_kv(state: PagedKVState, max_len: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Materialize each sequence's KV up to max_len.

    Returns (k [B, max_len, KVp, hd], v likewise, valid [B, max_len]).
    Dead table entries read row 0; ``valid`` masks by ``lengths``.
    """
    p = state.k_pool.shape[1]
    nb = -(-max_len // p)
    rows = state.block_table[:, :nb]
    table = torch.where(rows >= 0, rows, 0).long()
    k = state.k_pool[table]                    # [B, nb, P, KVp, hd]
    v = state.v_pool[table]
    b = k.shape[0]
    k = k.reshape(b, nb * p, *k.shape[3:])[:, :max_len]
    v = v.reshape(b, nb * p, *v.shape[3:])[:, :max_len]
    valid = (torch.arange(max_len, device=state.lengths.device)[None, :]
             < state.lengths[:, None])
    return k, v, valid


def paged_decode_attention(q: torch.Tensor, state: PagedKVState,
                           max_len: int) -> torch.Tensor:
    """q: [B, KVp, gp, hd] (one token) -> [B, KVp, gp, hd].

    Reference path: gathers the full KV, then a dense f32 softmax with the
    scores divided by ``sqrt(hd)`` and invalid positions at ``-1e30``.
    """
    k, v, valid = gather_kv(state, max_len)
    hd = q.shape[-1]
    scores = torch.einsum("bkgd,btkd->bkgt", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", w, v.float()).to(q.dtype)
