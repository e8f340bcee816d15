"""Serving loops (the port of ``repro.runtime.serve``): slot-based
continuous batching over a paged KV pool, and the windowed loop that
serves the stacks paged decode cannot.

``ContinuousBatchingEngine``:

A fixed set of *slots* shares a paged KV pool (``runtime/paging.py``).  A
request is admitted into any free slot the moment enough KV blocks exist
(its whole ``prompt_len + max_new`` budget is reserved up front, so a
running request can never strand mid-decode); it decodes for *exactly* its
own ``max_new`` steps; the step it finishes, its blocks free and its slot
is re-admittable.  Admission that would overcommit the pool raises
:class:`~repro_torch.runtime.paging.OutOfBlocksError` internally; the
request waits in the queue and the deferral is counted.  Attention runs
the paged-decode kernel (``kernels/paged_attention.py``), and the int8
segments of an ``"mpai"`` plan run the int8 GEMM kernel.  It serves every
attention-only stack without a sliding window or int8 KV, MoE MLPs
included.

Decoding is per-request (``runtime/sampling.py``): greedy (``argmax``, ties
to the lowest index) or temperature/top-k sampling keyed by
``fold_in(PRNGKey(seed), token_index)``, the reference's threefry stream
bit for bit (``core/prng.py``).  ``harden=True`` adds the reference's
radiation hardening: per-block KV checksums verified on every decode step,
sealing of full blocks, a budgeted ``scrub``, injected upsets
(``arm_bitflip``) and slot stalls (``stall_slot``), quarantine of a
corrupted block and exactly-once replay of the requests it held.

Co-processing (MPAI's prefill/decode split): ``prefill_handoff`` runs a
prompt through chunked paged prefill on a prefill-class engine, picks the
first token and exports the filled blocks as a :class:`PrefillHandoff`;
``import_prefill`` pastes them into a decode-class engine's pool and
resumes decode at token index 1.  ``PrefillHandoff.to_bytes`` /
``from_bytes`` are the reference's wire format v1 byte for byte (the
shared contract is the reference's ``repro/serving/WIRE_FORMAT.md``), so
a frame crosses between the two packages.  :class:`CoProcServer` serves
one prefill engine into N decode shards, every handoff through the wire,
with per-shard backpressure, shard retirement and exactly-once recovery
of lost or corrupted handoffs and of shard evictions (``restore_import``).

``WindowedBaselineServer`` — the windowed loop (greedy-only): a bounded
window of requests prefills together (left-padded to ``prompt_len``), then
every request decodes for ``max(max_new)`` steps against the dense caches
of ``T.init_cache``.  It serves what paged decode cannot: RWKV-6 stacks
(wkv kernel at prefill, recurrent state at decode), hybrid Mamba/attention
stacks such as Jamba (selective-scan kernel at prefill), and attention
stacks with a sliding window (a ring cache) or int8 KV (row-wise quant
kernel at every cache write).

``engine_or_windowed`` builds the engine and falls back to the windowed
loop for stacks paged decode cannot serve; ``BatchingServer`` is its
deprecated shim.

Progress: ``step()`` advances by one unit of work (the engine: hardening
upkeep, admissions and one decode step; the windowed loop: a window's
prefill or one decode step); ``flush()`` runs until at least one request
completes.
"""
from __future__ import annotations

import struct
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.runtime import paging
from repro_torch.runtime.paging import BlockAllocator, OutOfBlocksError
from repro_torch.runtime.sampling import GREEDY, SamplingParams, sample_logits


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [S] int32
    max_new: int = 8
    sampling: Optional[SamplingParams] = None   # None -> greedy
    output: Optional[np.ndarray] = None


@dataclass
class _Slot:
    """One occupied decode slot."""
    req: Request
    gen: List[int]                     # sampled tokens so far
    remaining: int                     # decode steps left (exact)
    sampled: bool = False              # non-greedy sampling requested


@dataclass
class _ActiveWindow:
    """One in-progress bounded window (prefill done, decode underway)."""
    batch: List[Request]
    cache: Dict
    last: torch.Tensor                 # [b, 1] last greedy token
    gen: List[np.ndarray]
    remaining: int                     # decode steps left
    steps_done: int = 0                # decode steps taken so far


_DEFER = object()        # admission verdict: blocks unavailable, retry later


def _require_prompt(req: Request, who: str) -> None:
    """Reject empty prompts up front: a zero-length prompt would select the
    whole bucket row when left-padded."""
    if req.prompt.shape[0] == 0:
        raise ValueError(
            f"request {req.rid}: empty prompt — the {who} needs at "
            f"least one prompt token to prefill")


def _gather_block_rows(caches, rows: torch.Tensor) -> Dict[str, tuple]:
    """Export the KV of block ``rows`` from every sublayer pool
    ``[n_super, NB+1, P, KVp, hd]``: ``{key: (k, v)}``, copies on the
    pools' device (the DPU->VPU transfer's source side)."""
    return {key: (st.k_pool.index_select(1, rows),
                  st.v_pool.index_select(1, rows))
            for key, st in caches.items()}


def _paste_block_rows(caches, kv: Dict[str, tuple],
                      rows: torch.Tensor) -> None:
    """Import handed-off KV into block ``rows`` of every sublayer pool
    (mirrored geometry), moved to the pools' device and cast to their
    dtype: the receiving side of the handoff."""
    for key, st in caches.items():
        k, v = kv[key]
        for pool, x in ((st.k_pool, k), (st.v_pool, v)):
            pool.index_copy_(1, rows, x.to(pool.device, pool.dtype))


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode over a paged KV pool.

    ``max_slots`` batch slots share a pool of ``num_blocks`` KV blocks of
    ``block_size`` tokens.  One ``step()`` = admissions (one fused bucket
    prefill + paste for every short prompt of the round, chunked paged
    prefill for each long one) + one batched decode step for every
    occupied slot.

    Sampling is per-request (``Request.sampling``): greedy when unset,
    otherwise temperature/top-k with a counter-based key
    (``fold_in(seed, token_index)``), so outputs do not depend on the
    batch's other rows' keys.  A round or step where no live row samples
    takes the plain argmax.

    ``on_token`` (``(rid, token)``) fires the step each token is picked,
    admission first-tokens included; ``on_stage`` (``(stage, t0, t1,
    rids, attrs)``) receives wall-clock spans of the device calls.

    The engine keeps the block table and per-slot lengths as host-side
    numpy mirrors (the allocator is host code) and copies them into every
    layer's :class:`~repro_torch.runtime.paging.PagedKVState` before a
    device call that needs them; the device-side length bumps of
    ``append_tokens`` are mirrored by the host bookkeeping.
    """

    def __init__(self, params, cfg: ModelConfig,
                 plan: Optional[PartitionPlan] = None, tp: int = 1,
                 max_slots: int = 8, prompt_len: int = 32,
                 max_len: int = 64, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 harden: bool = False, watchdog_steps: int = 8,
                 scrub_blocks: int = 2, device="cuda"):
        self.params, self.cfg, self.plan, self.tp = params, cfg, plan, tp
        self.device = torch.device(device)
        self.max_slots, self.prompt_len = max_slots, prompt_len
        self.max_len, self.block_size = max_len, block_size
        assert max_len > prompt_len, (max_len, prompt_len)
        # chunked paged prefill: prompts longer than the prompt_len
        # bucket admit in block-aligned chunks of this many tokens,
        # written straight into paged blocks
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else max(block_size,
                                       prompt_len // block_size
                                       * block_size))
        assert self.prefill_chunk % block_size == 0, \
            (self.prefill_chunk, block_size)
        self.table_width = -(-max_len // block_size)
        if num_blocks is None:
            num_blocks = max_slots * self.table_width
        assert num_blocks >= self.table_width, \
            "pool smaller than one max-length request"
        self.alloc = BlockAllocator(num_blocks)
        self.shared = paging.SharedBlockIndex(self.alloc)
        self.table = -np.ones((max_slots, self.table_width), np.int32)
        self.lengths = np.zeros(max_slots, np.int32)
        # a stack paged decode cannot serve raises ValueError here (before
        # anything else is built) and engine_or_windowed falls back
        self.caches = T.init_paged_decode_cache(
            cfg, max_slots, num_blocks, block_size, tp,
            max_blocks=self.table_width, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.last = np.zeros((max_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._dirty = True                    # host table/lengths changed
        # --- radiation hardening (SEU detection + recovery) -----------
        # harden=True turns on per-block integrity digests: sealed (full)
        # blocks are checksummed, every hardened decode step checksums the
        # whole pool after its KV append (detection lands the same step a
        # corrupted block is read, before any token escapes), and scrub()
        # gives idle pools a budgeted background pass.  The token path is
        # untouched: hardened outputs with no faults equal hardening-off.
        self.harden = bool(harden)
        self.watchdog_steps = int(watchdog_steps)
        self.scrub_blocks = int(scrub_blocks)
        self.digests = paging.BlockDigestStore()
        # whoever frees a block (finalize, shared-index refcount drop,
        # eviction) retires its seal with it
        self.alloc.on_release = self.digests.forget
        self.stalled: set = set()       # slots latched by a stall fault
        self._tripped: set = set()      # stalled slots already evicted
        self._stall_age = np.zeros(max_slots, np.int64)
        self._restore_queue: List[tuple] = []   # (req, gen) to replay
        self._armed_flips: List[int] = []       # kv_bitflip seeds pending
        self.mute_rids: set = set()     # one-shot emission suppression
        self._idle_steps = 0            # livelock guard
        # a co-processing decode shard must not restore itself: its KV came
        # from a prefill engine under another plan, so the seam's owner
        # re-runs the handoff instead (restore_import)
        self.external_restore = False
        self.on_token: Optional[Callable[[int, int], None]] = None
        self.on_stage = None
        # per-slot sampling knobs; their device copies are refreshed where
        # they change (admission, restore), the per-token step counters
        # only on steps where a live row samples
        self._temps = np.zeros(max_slots, np.float32)
        self._topks = np.zeros(max_slots, np.int32)
        self._seeds = np.zeros(max_slots, np.int32)
        self._gen_counts = np.zeros(max_slots, np.int32)  # tokens so far
        self._push_knobs()
        self.reset_stats()
        # admissions prefill together at the max_slots bucket (rows for
        # non-admitted slots are dead weight but keep shapes fixed)
        self._prefill_cache = T.init_cache(cfg, max_slots, prompt_len, tp,
                                           device=self.device)

    def reset_stats(self) -> None:
        """Zero the telemetry counters."""
        self.total_tokens = 0                 # real sampled tokens only
        self.decode_steps = 0
        self.occupancy_sum = 0.0
        self.decode_tokens = 0                # tokens from decode steps only
        self.decode_s = 0.0                   # wall time in decode steps
        self.admit_s = 0.0                    # wall time in admission steps
        self.prefill_tokens = 0               # prompt tokens prefilled
        self.deferrals = 0                    # OutOfBlocks admission deferrals
        self.shared.hits = 0                  # prefix blocks served by index
        self.shared.lookups = 0               # share attempts (hits + misses)
        self.bitflips_detected = 0            # checksum mismatches caught
        self.blocks_quarantined = 0           # blocks pulled from service
        self.watchdog_trips = 0               # stalled slots evicted
        self.replays = 0                      # evicted requests rebuilt
        self.scrubbed_blocks = 0              # blocks verified by scrub()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def padded_prompt_len(self, s: int) -> int:
        """Prompt context a length-``s`` prompt occupies once admitted:
        the ``prompt_len`` bucket when it fits (left-padded), else the
        next prefill-chunk multiple."""
        if s <= self.prompt_len:
            return self.prompt_len
        c = self.prefill_chunk
        return -(-s // c) * c

    def submit(self, req: Request) -> None:
        _require_prompt(req, "engine")
        padded = self.padded_prompt_len(int(req.prompt.shape[0]))
        assert padded + req.max_new <= self.max_len, \
            (req.rid, req.prompt.shape[0], req.max_new, self.max_len)
        self.queue.append(req)

    def _held_blocks(self) -> List[int]:
        """Per-slot count of blocks currently owned — the baseline
        ``plan_blocks`` needs: growing one row must restate every other
        row's holdings so nothing it already owns is re-planned."""
        return [int((self.table[j] >= 0).sum())
                for j in range(self.max_slots)]

    @property
    def pending(self) -> int:
        """Requests admitted but not yet completed (queued + in-slot +
        evicted-awaiting-replay)."""
        return (len(self.queue) + sum(s is not None for s in self.slots)
                + len(self._restore_queue))

    @property
    def occupancy(self) -> float:
        """Fraction of decode slots doing useful work right now."""
        return sum(s is not None for s in self.slots) / self.max_slots

    @property
    def prefix_hits(self) -> int:
        """Prompt blocks served from the content-hash index."""
        return self.shared.hits

    @property
    def prefix_lookups(self) -> int:
        """Prompt blocks offered to the index (hits + misses)."""
        return self.shared.lookups

    def step(self) -> List[Request]:
        """Admit into free slots, then run one decode step; returns the
        requests completed by either (admission completes ``max_new<=1``
        requests outright — their single token comes from prefill).

        Hardening rides the same cadence: armed bit flips land first (so
        detection sees them the very step their block is next read), the
        watchdog ages stalled slots, and evicted requests replay into free
        slots before new admissions."""
        if self._armed_flips:
            self._apply_armed_flips()
        if self.stalled:
            self._watchdog()
        if self._restore_queue and not self.external_restore:
            self._restore_pending()
        completed = self._admit()
        completed += self._decode_once()
        # livelock guard: a permanently-stalled single slot (or a restore
        # that can never fit) must fail loudly, not spin the drive loop
        if (completed or any(s is not None for s in self.slots)
                or not (self.queue or self._restore_queue)):
            self._idle_steps = 0
        else:
            self._idle_steps += 1
            if self._idle_steps > max(1000, 10 * self.watchdog_steps):
                raise RuntimeError(
                    f"engine livelock: {len(self.queue)} queued + "
                    f"{len(self._restore_queue)} awaiting replay, but no "
                    f"slot can make progress (stalled={sorted(self.stalled)},"
                    f" quarantined={len(self.alloc.quarantined)} blocks)")
        return completed

    def flush(self) -> List[Request]:
        """Blocking form: run until at least one request completes."""
        if not self.pending:
            return []
        while True:
            done = self.step()
            if done:
                return done

    def stats(self) -> Dict[str, float]:
        steps = max(self.decode_steps, 1)
        return {"total_tokens": self.total_tokens,
                "decode_steps": self.decode_steps,
                "mean_occupancy": self.occupancy_sum / steps,
                "decode_tokens": self.decode_tokens,
                "decode_s": self.decode_s,
                "admit_s": self.admit_s,
                "prefill_tokens": self.prefill_tokens,
                "shared_block_hits": self.shared.hits,
                "shared_block_lookups": self.shared.lookups,
                "deferrals": self.deferrals,
                "bitflips_detected": self.bitflips_detected,
                "blocks_quarantined": self.blocks_quarantined,
                "watchdog_trips": self.watchdog_trips,
                "replays": self.replays,
                "scrubbed_blocks": self.scrubbed_blocks}

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _push_knobs(self) -> None:
        """Copy the per-slot sampling knobs to the device (a copy even on
        the CPU, where ``as_tensor`` would share the host arrays)."""
        self._knobs_dev = tuple(torch.tensor(a, device=self.device)
                                for a in (self._temps, self._topks,
                                          self._seeds))

    def _set_knobs(self, i: int, sp: SamplingParams) -> None:
        self._temps[i], self._topks[i] = sp.temperature, sp.top_k
        self._seeds[i] = sp.seed

    def _pick(self, logits: torch.Tensor, sampled: bool, knobs=None,
              steps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One token per row of ``logits`` [B, V], on the device: argmax,
        or ``sample_logits`` with ``knobs`` (temps, top_ks, seeds) and
        per-row token indices ``steps`` (0 when None)."""
        if not sampled:
            return torch.argmax(logits, dim=-1)
        temps, topks, seeds = knobs
        if steps is None:
            steps = torch.zeros_like(seeds)
        return sample_logits(logits, temps, topks, seeds, steps)

    def _pick_first(self, logits: torch.Tensor, sp: SamplingParams) -> int:
        """A chunked admission's first token (token index 0) from its final
        chunk's last logits [1, V], with the request's own knobs."""
        knobs = (self._tensor(np.float32([sp.temperature])),
                 self._tensor(np.int32([sp.top_k])),
                 self._tensor(np.int32([sp.seed])))
        return int(self._pick(logits, not sp.greedy, knobs)[0])

    def _prefill_paste(self, toks: np.ndarray,
                       admit: np.ndarray) -> torch.Tensor:
        """Bucket-shaped prefill and the paste of every admitted row's KV
        into its paged blocks (non-admitted rows scatter to the trash
        row); returns the last position's logits [B, V]."""
        out = T.prefill(self.params, self.cfg, self._tensor(toks),
                        self._prefill_cache, self.plan, self.tp)
        admit_t = self._tensor(admit)
        for key, st in self.caches.items():
            dc = out.cache[key]
            for layer in range(st.k_pool.shape[0]):
                paging.write_prefill_batch(tree_map(lambda a: a[layer], st),
                                           dc.k[layer], dc.v[layer], admit_t)
        return out.logits[:, -1]

    def _push_tables(self, table: Optional[np.ndarray] = None,
                     lengths: Optional[np.ndarray] = None) -> None:
        """Copy the host table/length mirrors into every layer's cache.
        ``table``/``lengths`` override the mirrors for one push — the
        replay path masks every row but the one being rebuilt; the next
        dirty push restores the true mirrors."""
        tbl = self._tensor(self.table if table is None else table)
        lens = self._tensor(self.lengths if lengths is None else lengths)
        for st in self.caches.values():
            st.block_table.copy_(tbl.expand_as(st.block_table))
            st.lengths.copy_(lens.expand_as(st.lengths))

    def _emit(self, rid: int, tok: int) -> None:
        if self.on_token is not None:
            self.on_token(rid, tok)

    def _stage(self, stage: str, t0: float, t1: float, rids, **attrs):
        if self.on_stage is not None:
            self.on_stage(stage, t0, t1, list(rids), attrs)

    # ------------------------------------------------------------------
    # radiation hardening: injection, detection, recovery
    # ------------------------------------------------------------------
    def arm_bitflip(self, seed: int = 0) -> None:
        """Arm one SEU: at the next step with sealed live KV, flip one
        ``seed``-chosen bit in a live paged block."""
        self._armed_flips.append(int(seed))

    def stall_slot(self, slot: int) -> None:
        """Latch a slot-stall fault: the next request decoding in this
        slot stops making progress (admission still uses the slot) until
        the watchdog evicts it; after the trip the slot is kept from
        admission until :meth:`unstall_slot`."""
        self.stalled.add(int(slot) % self.max_slots)

    def unstall_slot(self, slot: int) -> None:
        i = int(slot) % self.max_slots
        self.stalled.discard(i)
        self._tripped.discard(i)
        self._stall_age[i] = 0

    def scrub(self, budget: Optional[int] = None) -> int:
        """Budgeted background integrity pass: verify up to ``budget``
        sealed blocks (round-robin) against their digests; corrupted
        blocks quarantine and their requests replay.  Returns blocks
        verified."""
        if not self.harden or len(self.digests) == 0:
            return 0
        blocks = self.digests.scrub_batch(
            self.scrub_blocks if budget is None else budget)
        if not blocks:
            return 0
        sums = self._row_checksums(blocks)
        self.scrubbed_blocks += len(blocks)
        bad_slots: set = set()
        for b, s in zip(blocks, sums):
            if self.digests.get(b) != int(s):
                bad_slots |= self._on_corrupt_block(b)
        for i in sorted(bad_slots):
            self._evict_slot(i)
        if bad_slots and not self.external_restore:
            self._restore_pending()
        return len(blocks)

    def _checksum(self) -> torch.Tensor:
        """Per-block checksums of every pool, summed over ``sorted(
        caches)`` mod 2**32: int64 [NB+1] on the device."""
        total = None
        for key in sorted(self.caches):
            s = paging.pool_checksums(self.caches[key])
            total = s if total is None else total + s
        return total & 0xFFFFFFFF

    def _row_checksums(self, blocks) -> np.ndarray:
        """Checksums for ``blocks``, indexed out of the full-pool one."""
        sums = self._checksum().cpu().numpy()
        return sums[np.asarray(blocks, np.int32)]

    def _seal_rows(self, blocks) -> None:
        """Digest freshly-finalized (full, no-longer-written) blocks."""
        if not self.harden:
            return
        bl = [int(b) for b in blocks if int(b) >= 0]
        if not bl:
            return
        for b, s in zip(bl, self._row_checksums(bl)):
            self.digests.seal(b, int(s))

    def _apply_armed_flips(self) -> None:
        """Land armed SEUs on sealed live blocks, each site drawn from
        ``np.random.default_rng(seed)`` in the reference's order (block,
        sublayer, pool, coordinate, bit).  Flips that cannot land yet (no
        sealed KV live) stay armed."""
        held = {int(b) for row in self.table for b in row if b >= 0}
        targets = sorted(b for b in held if b in self.digests)
        still_armed: List[int] = []
        for seed in self._armed_flips:
            if not targets:
                still_armed.append(seed)
                continue
            rng = np.random.default_rng(seed)
            b = int(targets[int(rng.integers(len(targets)))])
            key = sorted(self.caches)[int(rng.integers(len(self.caches)))]
            st = self.caches[key]
            pool = st.k_pool if int(rng.integers(2)) == 0 else st.v_pool
            sh = pool.shape                  # [S, NB+1, P, KVp, hd]
            coord = (int(rng.integers(sh[0])), b,
                     int(rng.integers(sh[2])), int(rng.integers(sh[3])),
                     int(rng.integers(sh[4])))
            nbits = pool.element_size() * 8
            bit = int(rng.integers(nbits))
            words = pool.view(torch.int16 if nbits == 16 else torch.int32)
            # the top bit is the sign bit of the signed word
            words[coord] ^= -(1 << bit) if bit == nbits - 1 else 1 << bit
            t = time.perf_counter()
            self._stage("seu_bitflip", t, t, [], block=b, bit=bit,
                        seed=seed)
        self._armed_flips = still_armed

    def _watchdog(self) -> None:
        """Age occupied stalled slots; past the threshold, evict the
        request for replay and keep the slot from admission."""
        for i in sorted(self.stalled):
            s = self.slots[i]
            if s is None or i in self._tripped:
                continue
            self._stall_age[i] += 1
            if self._stall_age[i] < self.watchdog_steps:
                continue
            self.watchdog_trips += 1
            self._tripped.add(i)
            self._stall_age[i] = 0
            t = time.perf_counter()
            self._stage("watchdog_trip", t, t, [s.req.rid], slot=i,
                        tokens=len(s.gen))
            self._evict_slot(i)

    def _evict_slot(self, i: int) -> None:
        """Tear a slot down for replay: free its row exactly (shared
        refcounts honored, quarantined blocks skipped by the allocator)
        and queue (request, tokens-so-far) for restoration."""
        s = self.slots[i]
        self.alloc.release(
            self.shared.release(self.table[i][self.table[i] >= 0]))
        self.table[i] = -1
        self.lengths[i] = 0
        self._gen_counts[i] = 0
        self.slots[i] = None
        self._dirty = True
        self._restore_queue.append((s.req, list(s.gen)))

    def _on_corrupt_block(self, b: int) -> set:
        """Account one detected upset: quarantine the block, purge it
        from the shared index, drop its seal; returns the occupied slots
        whose rows hold it."""
        self.bitflips_detected += 1
        if self.alloc.quarantine(b):
            self.blocks_quarantined += 1
        self.shared.purge(b)
        self.digests.forget(b)
        t = time.perf_counter()
        self._stage("bitflip_detected", t, t, [], block=b)
        return {i for i in range(self.max_slots)
                if self.slots[i] is not None and b in self.table[i]}

    def _restore_pending(self) -> None:
        """Replay evicted requests into free, healthy slots (recovery
        runs before new admissions; deferred under block pressure)."""
        while self._restore_queue:
            req, gen = self._restore_queue[0]
            # only watchdog-proven slots are avoided
            free = [i for i in range(self.max_slots)
                    if self.slots[i] is None and i not in self._tripped]
            if not free:
                break
            try:
                self._restore_slot(free[0], req, gen)
            except OutOfBlocksError:
                self.deferrals += 1
                break
            self._restore_queue.pop(0)
            self.replays += 1

    def _restore_slot(self, i: int, req: Request, gen: List[int]) -> None:
        """Rebuild an evicted in-flight request in slot ``i``: re-prefill
        its prompt (sharing live prefix blocks through the content-hash
        index), then replay the recorded generated tokens through the
        decode step.  Nothing is re-emitted, so the stream continues
        exactly once from where it stopped."""
        s = int(req.prompt.shape[0])
        sp = req.sampling or GREEDY
        bs = self.block_size
        if s <= self.prompt_len:
            padded_len = self.prompt_len
            need = self._held_blocks()
            need[i] = -(-(self.prompt_len + req.max_new) // bs)
            self.table = paging.plan_blocks(self.table, self.alloc, need)
            self._push_tables()
            self._dirty = False
            toks = np.zeros((self.max_slots, self.prompt_len), np.int32)
            toks[i, -s:] = req.prompt
            admit = np.zeros(self.max_slots, bool)
            admit[i] = True
            self._set_knobs(i, sp)
            self._push_knobs()
            t0 = time.perf_counter()
            self._prefill_paste(toks, admit)   # its token is known: unused
            self.admit_s += time.perf_counter() - t0
            self.prefill_tokens += self.prompt_len
            self.lengths[i] = self.prompt_len
        else:
            padded, digests, shared_blocks = self._plan_chunked(i, req)
            self._push_tables()
            self._dirty = False
            self._set_knobs(i, sp)
            self._push_knobs()
            self._run_chunks(i, padded, shared_blocks * bs
                             // self.prefill_chunk, rid=req.rid)
            for b in range(shared_blocks, len(digests)):
                self.shared.register(digests[b], int(self.table[i, b]))
            padded_len = padded.shape[0]
            self.lengths[i] = padded_len
        self._replay_generation(i, req, gen, padded_len, sp)

    def _replay_generation(self, i: int, req: Request, gen: List[int],
                           padded_len: int, sp: SamplingParams) -> None:
        """Replay recorded tokens ``gen[:-1]`` as decode inputs so the KV
        the lost steps had written is regrown; every other row is masked
        off the device tables for the duration.  Outputs are recomputed
        and discarded — nothing re-emits."""
        g = len(gen)
        t0 = time.perf_counter()
        if g > 1:
            mask_tbl = -np.ones_like(self.table)
            mask_tbl[i] = self.table[i]
            mask_len = np.zeros_like(self.lengths)
            mask_len[i] = padded_len
            self._push_tables(mask_tbl, mask_len)
            last = np.zeros((self.max_slots, 1), np.int32)
            for j in range(g - 1):
                last[i, 0] = gen[j]
                T.decode_step(self.params, self.cfg, self._tensor(last),
                              self.caches, self.plan, self.tp)
        self.admit_s += time.perf_counter() - t0
        self.lengths[i] = padded_len + g - 1
        self._gen_counts[i] = g
        self.slots[i] = _Slot(req, list(gen), req.max_new - g,
                              sampled=not sp.greedy)
        self.last[i, 0] = gen[-1]
        self._dirty = True
        self._seal_rows(self.table[i][:self.lengths[i] // self.block_size])
        t1 = time.perf_counter()
        self._stage("replay", t0, t1, [req.rid], tokens=g, slot=i)

    def restore_import(self, req: Request, gen: List[int],
                       handoff: "PrefillHandoff") -> None:
        """Co-processing recovery: rebuild an evicted decode slot from a
        fresh handoff (the imported KV carries the prefill engine's bits;
        this engine's own prefill, under its own plan, might not), then
        replay the recorded tokens.  Raises ``OutOfBlocksError`` to defer
        under pressure; the caller keeps the handoff so prefill is not
        repeated."""
        free = [j for j in range(self.max_slots)
                if self.slots[j] is None and j not in self._tripped]
        if not free:
            raise OutOfBlocksError("decode engine has no healthy free slot")
        i = free[0]
        bs, length = self.block_size, handoff.length
        need = self._held_blocks()
        need[i] = -(-(length + req.max_new) // bs)
        self.table = paging.plan_blocks(self.table, self.alloc, need)
        rows = self.table[i][:length // bs]
        _paste_block_rows(self.caches, handoff.kv,
                          self._tensor(rows.astype(np.int64)))
        self._verify_import(i, req, handoff, rows)
        self.lengths[i] = length
        sp = req.sampling or GREEDY
        self._set_knobs(i, sp)
        self._push_knobs()
        self._replay_generation(i, req, gen, length, sp)

    def _verify_import(self, i: int, req: Request,
                       handoff: "PrefillHandoff", rows) -> None:
        """Verify an import (hardened engines, digested handoffs): the
        pasted rows' checksums against the digests stamped at gather
        time.  A mismatch frees the planned row and raises
        :class:`HandoffCorruptError` (the seam re-requests the handoff);
        a clean import seals the rows with the sums just computed."""
        if not self.harden or handoff.digests is None:
            return
        sums = self._row_checksums([int(b) for b in rows])
        if any(int(a) != int(e) for a, e in zip(sums, handoff.digests)):
            self.alloc.release(self.table[i][self.table[i] >= 0])
            self.table[i] = -1
            self._dirty = True
            raise HandoffCorruptError(
                f"handoff for request {req.rid} failed integrity verify")
        for b, s in zip(rows, sums):
            self.digests.seal(int(b), int(s))

    # ------------------------------------------------------------------
    # admission and decode
    # ------------------------------------------------------------------
    def _admit(self) -> List[Request]:
        admits: List[tuple] = []
        completed: List[Request] = []
        for i in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[i] is not None or i in self._tripped:
                continue               # occupied, or watchdog-proven bad
            req = self.queue[0]
            if req.prompt.shape[0] > self.prompt_len:
                # over-bucket prompt: chunked paged prefill (shares prefix
                # blocks when the content-hash index has them live)
                res = self._admit_chunked(i, req)
                if res is _DEFER:
                    self.deferrals += 1
                    break
                self.queue.pop(0)
                if res is not None:
                    completed.append(res)
                continue
            need = self._held_blocks()
            need[i] = -(-(self.prompt_len + req.max_new) // self.block_size)
            try:
                self.table = paging.plan_blocks(self.table, self.alloc, need)
            except OutOfBlocksError:
                self.deferrals += 1    # defer admission; blocks will free
                break
            admits.append((i, self.queue.pop(0)))
        if not admits:
            return completed
        self._push_tables()                # freed + freshly-planned rows
        self._dirty = False
        # every admission this round rides one prefill+paste; each admitted
        # request occupies its slot's batch row, dead rows keep the shape
        toks = np.zeros((self.max_slots, self.prompt_len), np.int32)
        admit = np.zeros(self.max_slots, bool)
        any_sampled = False
        for i, req in admits:
            toks[i, -req.prompt.shape[0]:] = req.prompt      # left-pad
            admit[i] = True
            sp = req.sampling or GREEDY
            self._set_knobs(i, sp)
            any_sampled |= not sp.greedy
        self._push_knobs()
        t0 = time.perf_counter()
        logits = self._prefill_paste(toks, admit)
        # token index 0 keys every admission's first draw
        firsts = self._pick(logits, any_sampled,
                            self._knobs_dev).cpu().numpy()
        t1 = time.perf_counter()
        self.admit_s += t1 - t0
        self._stage("admit", t0, t1, [req.rid for _, req in admits],
                    tokens=self.prompt_len * len(admits))
        seal: List[int] = []
        for i, req in admits:
            self.lengths[i] = self.prompt_len
            self._gen_counts[i] = 1
            self.prefill_tokens += self.prompt_len
            if self.harden and req.max_new > 1:   # staying: seal the full
                seal.extend(                      # prompt blocks now
                    int(b) for b in
                    self.table[i][:self.prompt_len // self.block_size])
            tok = int(firsts[i])
            if req.max_new >= 1:
                # a max_new=0 request emits nothing and counts no token
                self.total_tokens += 1
                self._emit(req.rid, tok)
            if req.max_new <= 1:       # done at admission (0 => empty)
                completed.append(
                    self._finalize(i, req, [tok][:req.max_new]))
            else:
                sp = req.sampling or GREEDY
                self.slots[i] = _Slot(req, [tok], req.max_new - 1,
                                      sampled=not sp.greedy)
                self.last[i, 0] = tok
        self._seal_rows(seal)
        return completed

    def _run_chunks(self, i: int, padded: np.ndarray, first_chunk: int,
                    rid: Optional[int] = None) -> torch.Tensor:
        """Run ``padded``'s chunks from ``first_chunk`` on through chunked
        paged prefill; returns the final chunk's last logits [1, V]."""
        c = self.prefill_chunk
        t0 = ct0 = time.perf_counter()
        logits = None
        for ci in range(first_chunk, padded.shape[0] // c):
            out = T.prefill_paged_chunk(
                self.params, self.cfg,
                self._tensor(padded[ci * c:(ci + 1) * c][None]),
                self.caches, i, ci * c, self.plan, self.tp)
            logits = out.logits[:, -1]
            if self.on_stage is not None:
                ct1 = time.perf_counter()
                self._stage("prefill_chunk", ct0, ct1, [rid],
                            chunk=ci, tokens=c)
                ct0 = ct1
        self.admit_s += time.perf_counter() - t0
        self.prefill_tokens += padded.shape[0] - first_chunk * c
        return logits

    def _plan_chunked(self, i: int, req: Request):
        """Left-pad ``req``'s prompt to whole prefill chunks, take live
        shared prefix blocks (whole chunks only — the final chunk always
        recomputes) and plan the row's full budget into slot ``i``.
        Returns ``(padded, digests, shared_blocks)``; raises
        ``OutOfBlocksError`` with nothing leaked."""
        bs, c = self.block_size, self.prefill_chunk
        s = int(req.prompt.shape[0])
        length = -(-s // c) * c
        padded = np.zeros(length, np.int32)
        padded[length - s:] = req.prompt
        n_prompt_blocks = length // bs
        per_chunk = c // bs
        digests = []
        d = paging.SharedBlockIndex.ROOT
        for b in range(n_prompt_blocks):
            d = self.shared.chain(d, padded[b * bs:(b + 1) * bs])
            digests.append(d)
        hit = 0
        for b in range(n_prompt_blocks - per_chunk):
            if self.shared.lookup(digests[b]) is None:
                break
            hit = b + 1
        shared_blocks = (hit // per_chunk) * per_chunk
        acquired = [self.shared.acquire(digests[b])
                    for b in range(shared_blocks)]
        self.table[i, :shared_blocks] = acquired
        need = self._held_blocks()
        need[i] = -(-(length + req.max_new) // bs)
        try:
            self.table = paging.plan_blocks(self.table, self.alloc, need)
        except OutOfBlocksError:
            self.shared.release(acquired)   # refs only; owners keep blocks
            self.shared.hits -= len(acquired)   # retry will re-count them
            self.table[i, :shared_blocks] = -1
            raise
        return padded, digests, shared_blocks

    def _admit_chunked(self, i: int, req: Request):
        """Admit one over-bucket prompt into slot ``i`` via chunked paged
        prefill: the prompt's full block budget (padded prompt + max_new)
        reserved atomically, live identical prefix chunks shared through
        the content-hash index, each other chunk one prefill+paste call;
        the final chunk's last logits pick the first token (token index
        0).  Returns the completed Request for ``max_new<=1``, None when
        the request now occupies the slot, or ``_DEFER`` when the pool
        cannot cover it yet (nothing leaks)."""
        try:
            padded, digests, shared_blocks = self._plan_chunked(i, req)
        except OutOfBlocksError:
            return _DEFER
        self._push_tables()
        self._dirty = False
        sp = req.sampling or GREEDY
        self._set_knobs(i, sp)
        self._push_knobs()
        logits = self._run_chunks(i, padded, shared_blocks * self.block_size
                                  // self.prefill_chunk, rid=req.rid)
        tok = self._pick_first(logits, sp)
        # publish the freshly prefilled prompt blocks for future sharers
        # (all are full, read-only blocks: decode appends start a new
        # block because the padded length is block-aligned)
        for b in range(shared_blocks, len(digests)):
            self.shared.register(digests[b], int(self.table[i, b]))
        self.lengths[i] = padded.shape[0]
        self._gen_counts[i] = 1
        if self.harden and req.max_new > 1:
            # freshly prefilled prompt blocks are full and read-only from
            # here on (shared-index hits were sealed by their writer)
            self._seal_rows(self.table[i][shared_blocks:len(digests)])
        if req.max_new >= 1:
            self.total_tokens += 1
            self._emit(req.rid, tok)
        if req.max_new <= 1:
            return self._finalize(i, req, [tok][:req.max_new])
        self.slots[i] = _Slot(req, [tok], req.max_new - 1,
                              sampled=not sp.greedy)
        self.last[i, 0] = tok
        return None

    def _decode_once(self) -> List[Request]:
        # stalled slots occupy their row but make no progress — the
        # latched fault is latent until the watchdog trips it
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self.stalled]
        if not active:
            return []
        if self._dirty:
            self._push_tables()
            self._dirty = False
        any_sampled = any(s is not None and s.sampled for s in self.slots)
        t0 = time.perf_counter()
        out = T.decode_step(self.params, self.cfg, self._tensor(self.last),
                            self.caches, self.plan, self.tp)
        nxt = self._pick(out.logits[:, -1], any_sampled, self._knobs_dev,
                         self._tensor(self._gen_counts) if any_sampled
                         else None)
        sums_np: Optional[np.ndarray] = None
        if self.harden:
            # the whole pool's per-block checksums after this step's KV
            # append, fetched with the tokens in one copy: detection lands
            # the same step a corrupted block is read, before any token of
            # this step escapes to a stream
            host = torch.cat([nxt, self._checksum()]).cpu().numpy()
            nxt, sums_np = host[:self.max_slots], host[self.max_slots:]
        else:
            nxt = nxt.cpu().numpy()
        t1 = time.perf_counter()
        self.decode_s += t1 - t0
        self._stage("decode_step", t0, t1,
                    [self.slots[i].req.rid for i in active],
                    step=self.decode_steps, tokens=len(active))
        bad_slots: set = set()
        if sums_np is not None and len(self.digests):
            # every sealed block is verified every step
            items = self.digests.items()
            blks = np.fromiter((b for b, _ in items), np.int64, len(items))
            seals = np.fromiter((d for _, d in items), np.int64, len(items))
            for b in blks[sums_np[blks] != seals]:
                bad_slots |= self._on_corrupt_block(int(b))
        completed: List[Request] = []
        emitted = 0
        for i in active:
            if i in bad_slots:
                continue       # computed from corrupted KV: never emits
            self.lengths[i] += 1           # mirror device append_tokens
            self._gen_counts[i] += 1
            s = self.slots[i]
            tok = int(nxt[i])
            s.gen.append(tok)
            s.remaining -= 1
            self.last[i, 0] = tok
            self._emit(s.req.rid, tok)
            emitted += 1
            if self.harden and self.lengths[i] % self.block_size == 0:
                # this step's append just filled a block: its sum from
                # this step is the seal
                b = int(self.table[i,
                                   self.lengths[i] // self.block_size - 1])
                if 0 <= b < self.alloc.num_blocks and sums_np is not None:
                    self.digests.seal(b, int(sums_np[b]))
            if s.remaining <= 0:
                completed.append(self._finalize(i, s.req, s.gen))
                self.slots[i] = None
        for i in sorted(bad_slots):
            self._evict_slot(i)
        self.decode_steps += 1
        self.total_tokens += emitted
        self.decode_tokens += emitted
        self.occupancy_sum += len(active) / self.max_slots
        return completed

    def _finalize(self, i: int, req: Request, gen: List[int]) -> Request:
        req.output = np.asarray(gen, np.int32)
        self.done[req.rid] = req
        # shared prompt blocks are refcounted by the content-hash index
        # (freed with their last referencing sequence); the rest of the
        # row goes straight back to the allocator
        self.alloc.release(
            self.shared.release(self.table[i][self.table[i] >= 0]))
        self.table[i] = -1
        self.lengths[i] = 0
        self._dirty = True        # device sees the freed row at next push
        return req

    # ------------------------------------------------------------------
    # co-processing handoff (prefill-class <-> decode-class engines)
    # ------------------------------------------------------------------
    def prefill_handoff(self, req: Request) -> "PrefillHandoff":
        """Prefill ``req``'s prompt on this engine and export its KV blocks
        for a decode engine: MPAI's DPU->VPU handoff.  The prompt is
        left-padded to ``ceil(max(s, prompt_len) / prefill_chunk)`` chunks
        and always runs through chunked paged prefill; the final chunk's
        last logits pick the first token (token index 0, this engine's
        plan: the prefill stage owns it), which is emitted here unless the
        rid is muted (a replayed handoff).  The blocks are gathered and
        freed before returning.  Raises ``OutOfBlocksError`` when the
        prompt cannot be covered now (nothing is held: retry later)."""
        _require_prompt(req, "engine")
        bs, c = self.block_size, self.prefill_chunk
        length = -(-max(int(req.prompt.shape[0]), self.prompt_len) // c) * c
        free = [j for j, sl in enumerate(self.slots)
                if sl is None and j not in self._tripped]
        if not free:
            raise OutOfBlocksError("prefill engine has no free slot")
        i = free[0]
        padded = np.zeros(length, np.int32)
        padded[length - req.prompt.shape[0]:] = req.prompt
        need = self._held_blocks()
        need[i] = length // bs            # prompt only: no decode budget
        self.table = paging.plan_blocks(self.table, self.alloc, need)
        self._push_tables()
        self._dirty = False
        sp = req.sampling or GREEDY
        tok = self._pick_first(self._run_chunks(i, padded, 0, rid=req.rid),
                               sp)
        if req.rid in self.mute_rids:
            # a replayed handoff (the original was lost or corrupted after
            # its first token streamed): recomputed, emitted nothing
            self.mute_rids.discard(req.rid)
        elif req.max_new >= 1:
            self.total_tokens += 1
            self._emit(req.rid, tok)
        rows = self.table[i][:length // bs].copy()
        g0 = time.perf_counter()
        kv = _gather_block_rows(self.caches,
                                self._tensor(rows.astype(np.int64)))
        digests = None
        if self.harden:
            # the payload's per-block checksums, stamped before the blocks
            # free: the importer verifies its paste against them
            digests = tuple(int(s) for s in
                            self._row_checksums([int(b) for b in rows]))
        self._stage("handoff", g0, time.perf_counter(), [req.rid],
                    blocks=len(rows), tokens=length)
        self.alloc.release(self.shared.release(rows))
        self.table[i] = -1
        self.lengths[i] = 0
        self._dirty = True
        return PrefillHandoff(req.rid, tok, length, self.block_size, kv,
                              digests)

    def import_prefill(self, req: Request,
                       handoff: "PrefillHandoff") -> Optional[Request]:
        """Admit a request a co-processing peer already prefilled: reserve
        its whole block budget, paste the handed-off blocks into this
        engine's pool and resume decode after the peer's first token
        (emitted there, not again here).  Returns the completed Request
        for ``max_new<=1``, else None; raises ``OutOfBlocksError`` when
        blocks or slots are short (callers defer), and
        :class:`HandoffCorruptError` when a hardened import fails its
        verify."""
        assert handoff.block_size == self.block_size, \
            (f"mirrored pools must share block geometry: handoff wrote "
             f"{handoff.block_size}-token blocks, this pool holds "
             f"{self.block_size}-token blocks")
        free = [j for j, sl in enumerate(self.slots)
                if sl is None and j not in self._tripped]
        if not free:
            raise OutOfBlocksError("decode engine has no free slot")
        i = free[0]
        bs, length = self.block_size, handoff.length
        assert length + req.max_new <= self.table_width * bs, \
            (req.rid, length, req.max_new, self.max_len)
        need = self._held_blocks()
        need[i] = -(-(length + req.max_new) // bs)
        self.table = paging.plan_blocks(self.table, self.alloc, need)
        rows = self.table[i][:length // bs]
        p0 = time.perf_counter()
        _paste_block_rows(self.caches, handoff.kv,
                          self._tensor(rows.astype(np.int64)))
        self._stage("import", p0, time.perf_counter(), [req.rid],
                    blocks=len(rows), tokens=length)
        self._verify_import(i, req, handoff, rows)
        self.lengths[i] = length
        self._gen_counts[i] = 1
        self._dirty = True                # table + lengths push next step
        sp = req.sampling or GREEDY
        self._set_knobs(i, sp)
        self._push_knobs()
        tok = handoff.first_token
        if req.max_new <= 1:
            return self._finalize(i, req, [tok][:req.max_new])
        self.slots[i] = _Slot(req, [tok], req.max_new - 1,
                              sampled=not sp.greedy)
        self.last[i, 0] = tok
        return None


# ---------------------------------------------------------------------------
# Prefill/decode disaggregation (MPAI co-processing)
# ---------------------------------------------------------------------------
class HandoffCorruptError(RuntimeError):
    """A PrefillHandoff failed its integrity check (the frame checksum, or
    a per-block digest after the paste): the seam re-requests the handoff
    (prefill is deterministic, so the replacement carries the same bits
    and the first token already streamed stays valid)."""


class HandoffWireError(ValueError):
    """A PrefillHandoff frame is structurally unusable: wrong magic, an
    unknown version or dtype, a truncated or underrun frame.  Unlike
    :class:`HandoffCorruptError`, retrying the same bytes cannot help: the
    two ends do not speak the same format."""


#: PrefillHandoff wire schema version.  The layout, its versioning rules
#: and its failure taxonomy are the reference's
#: ``repro/serving/WIRE_FORMAT.md`` (version 1), which both packages speak
#: byte for byte: a frame written by either parses in the other.
WIRE_VERSION = 1
_WIRE_MAGIC = b"MPAI"
_WIRE_HEADER = "<HQI"                  # version, payload length, checksum

# wire dtype names (numpy's, and ml_dtypes' for bfloat16 and the fp8
# formats) and the torch dtypes they carry
_WIRE_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "float8_e4m3fnuz": torch.float8_e4m3fnuz,
    "float8_e5m2fnuz": torch.float8_e5m2fnuz,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8,
}
_WIRE_NAMES = {dt: name for name, dt in _WIRE_DTYPES.items()}


def _wire_dtype(name: str) -> torch.dtype:
    """The torch dtype of a serialized dtype name."""
    try:
        return _WIRE_DTYPES[name]
    except KeyError:
        raise HandoffWireError(
            f"handoff wire carries unknown dtype {name!r}") from None


def _pack_array(a: torch.Tensor) -> bytes:
    """One array on the wire: dtype name, shape and the raw C-order bytes
    of a host copy."""
    a = a.detach().cpu().contiguous()
    name = _WIRE_NAMES[a.dtype].encode()
    raw = a.reshape(-1).view(torch.uint8).numpy().tobytes()
    return b"".join([
        struct.pack("<i", len(name)), name,
        struct.pack("<i", a.dim()),
        struct.pack(f"<{a.dim()}q", *a.shape),
        struct.pack("<q", len(raw)), raw])


@dataclass
class PrefillHandoff:
    """One prefilled prompt crossing the co-processing seam.

    Made by :meth:`ContinuousBatchingEngine.prefill_handoff` on the
    prefill-class engine, taken by
    :meth:`ContinuousBatchingEngine.import_prefill` on a decode-class one.
    Carries the first token (the prefill stage picks it), the padded prompt
    length and each sublayer's block KV, ``kv[key] = (k, v)`` of shape
    ``[n_super, n_blocks, P, KVp, hd]`` in the block geometry both pools
    share: tensors on the exporter's device, or on the CPU once parsed from
    the wire (the importer moves them to its own).

    ``to_bytes`` / ``from_bytes`` are the wire format: versioned, checked
    by a whole-frame checksum, bit-exact for every pool dtype.  Every
    :class:`CoProcServer` handoff crosses the seam in wire form.
    """
    rid: int
    first_token: int
    length: int                        # padded prompt length (tokens)
    block_size: int
    kv: Dict[str, tuple]
    # per-block checksums stamped at gather time (hardened prefill engines
    # only): the importer verifies its paste against them
    digests: Optional[tuple] = None

    def to_bytes(self) -> bytes:
        """Serialize to the version-1 frame::

            MAGIC(4) | version(u16) | payload_len(u64) | checksum(u32)
            payload: rid(i64) first_token(i32) length(i32)
                     block_size(i32) digests(i32 count, -1=None, u32*)
                     kv(i32 count; per sorted key: name, K arr, V arr)

        Arrays carry dtype name, shape and raw bytes (copied to the host);
        the checksum is :func:`repro_torch.runtime.paging.wire_checksum`
        of the payload."""
        parts = [struct.pack("<qiii", self.rid, self.first_token,
                             self.length, self.block_size)]
        if self.digests is None:
            parts.append(struct.pack("<i", -1))
        else:
            digs = [int(d) & 0xFFFFFFFF for d in self.digests]
            parts.append(struct.pack(f"<i{len(digs)}I", len(digs), *digs))
        parts.append(struct.pack("<i", len(self.kv)))
        for key in sorted(self.kv):
            k, v = self.kv[key]
            kb = key.encode()
            parts.append(struct.pack("<i", len(kb)) + kb)
            parts.append(_pack_array(k))
            parts.append(_pack_array(v))
        payload = b"".join(parts)
        head = _WIRE_MAGIC + struct.pack(
            _WIRE_HEADER, WIRE_VERSION, len(payload),
            paging.wire_checksum(payload))
        return head + payload

    @classmethod
    def from_bytes(cls, buf: bytes) -> "PrefillHandoff":
        """Parse a wire frame into a handoff holding CPU tensors.  Raises
        :class:`HandoffWireError` on a structural fault (bad magic, another
        version, truncation, an underrun, an unknown dtype) and
        :class:`HandoffCorruptError` when an intact frame fails its
        checksum."""
        buf = bytearray(buf)     # mutable: torch.frombuffer takes it as is
        hdr = 4 + struct.calcsize(_WIRE_HEADER)
        if len(buf) < hdr:
            raise HandoffWireError(
                f"handoff frame truncated: {len(buf)} bytes < {hdr}-byte "
                f"header")
        if bytes(buf[:4]) != _WIRE_MAGIC:
            raise HandoffWireError(
                f"not a PrefillHandoff frame (magic {bytes(buf[:4])!r})")
        version, plen, want = struct.unpack_from(_WIRE_HEADER, buf, 4)
        if version != WIRE_VERSION:
            raise HandoffWireError(
                f"handoff wire version {version} != {WIRE_VERSION}; both "
                f"seam ends must run the same schema")
        if len(buf) - hdr != plen:
            raise HandoffWireError(
                f"handoff frame truncated: payload {len(buf) - hdr} bytes, "
                f"header declares {plen}")
        if paging.wire_checksum(bytes(buf[hdr:])) != want:
            raise HandoffCorruptError(
                "handoff frame failed its wire checksum (payload upset "
                "in transit)")
        off = hdr

        def underrun():
            return HandoffWireError(
                "handoff payload underruns its declared structure")

        def take(fmt):
            nonlocal off
            size = struct.calcsize(fmt)
            if off + size > len(buf):
                raise underrun()
            vals = struct.unpack_from(fmt, buf, off)
            off += size
            return vals

        def take_name() -> str:
            nonlocal off
            (n,) = take("<i")
            if n < 0 or off + n > len(buf):
                raise underrun()
            off += n
            return bytes(buf[off - n:off]).decode()

        def take_array() -> torch.Tensor:
            nonlocal off
            dtype = _wire_dtype(take_name())
            (ndim,) = take("<i")
            shape = take(f"<{ndim}q")
            (rlen,) = take("<q")
            nbytes = (int(np.prod(shape, dtype=np.int64))
                      * torch.empty((), dtype=dtype).element_size())
            if rlen != nbytes or off + rlen > len(buf):
                raise underrun()
            if nbytes == 0:
                a = torch.empty(shape, dtype=dtype)
            else:        # a copy: aligned, and independent of the frame
                a = torch.frombuffer(buf, dtype=torch.uint8, count=nbytes,
                                     offset=off).clone().view(dtype)
            off += rlen
            return a.reshape(shape)

        rid, first_token, length, block_size = take("<qiii")
        (ndig,) = take("<i")
        digests = None if ndig < 0 else tuple(take(f"<{ndig}I"))
        (nkv,) = take("<i")
        kv = {}
        for _ in range(nkv):
            key = take_name()
            kv[key] = (take_array(), take_array())
        return cls(rid, first_token, length, block_size, kv, digests)


class CoProcServer:
    """Disaggregated serving: one prefill-class engine feeding N decode
    shards over mirrored paged pools.

    MPAI's co-processing split as a server: stage 1 (the DPU analogue,
    typically under a cheaper int8 plan) runs chunked paged prefill and
    picks the first token; stage 2 (the VPU analogue) imports the filled
    blocks into its own pool and decodes.  Stage 2 may be sharded: N
    identical decode engines, each with its own allocator and slots.  Every
    handoff crosses the seam in :meth:`PrefillHandoff.to_bytes` form.  The
    importer is the least-loaded live shard; a shard that cannot take a
    handoff defers to the next, and only when every live shard defers does
    the request park at the seam (its prefill is not repeated).  A lost or
    corrupted handoff is re-requested exactly once: prefill replays muted
    (deterministic, so bit-identical), and delivered tokens stay delivered
    once.  Shard evictions (a detected upset, a watchdog trip) come back
    through a fresh handoff (:meth:`_drain_restores`).

    It has the engines' ``submit`` / ``step`` / ``flush`` / ``done`` /
    ``stats`` API, so :class:`~repro_torch.serving.executor.EngineExecutor`
    drives it unchanged; the per-stage counters (``prefill_tokens`` and
    ``admit_s`` from the prefill engine, decode counters summed over the
    shards) let the executor charge each stage to its own pool.
    """

    def __init__(self, prefill_engine: ContinuousBatchingEngine,
                 decode_engines: Union[ContinuousBatchingEngine,
                                       Sequence[ContinuousBatchingEngine]]):
        if isinstance(decode_engines, ContinuousBatchingEngine):
            decode_engines = [decode_engines]
        self.decodes: List[ContinuousBatchingEngine] = list(decode_engines)
        assert self.decodes, "need at least one decode shard"
        for eng in self.decodes:
            assert prefill_engine.block_size == eng.block_size, \
                "mirrored pools must share block geometry"
        self.prefill = prefill_engine
        self.max_len = min(e.max_len for e in self.decodes)
        self.prompt_len = self.decodes[0].prompt_len
        self.queue: List[Request] = []
        self._parked: Optional[tuple] = None   # (req, handoff) at the seam
        self.handoff_count = 0
        self._seam_deferrals = 0
        self._on_token: Optional[Callable[[int, int], None]] = None
        self._on_stage = None
        # the seam owns every shard's restore queue: an eviction's KV must
        # come back with the prefill engine's bits
        for eng in self.decodes:
            eng.external_restore = True
        self._restore_parked: Optional[tuple] = None  # (shard, req, gen, ho)
        self._lose_handoffs = 0        # armed handoff_loss faults
        self._corrupt_wire = 0         # armed in-transit frame upsets
        self.handoffs_lost = 0
        self.handoffs_replayed = 0
        self._draining: set = set()    # shard indices leaving the rotation
        self.imports_by_shard: Dict[str, int] = {
            f"shard{i}": 0 for i in range(len(self.decodes))}
        self.seam_deferrals_by_shard: Dict[str, int] = {
            f"shard{i}": 0 for i in range(len(self.decodes))}

    @property
    def decode(self) -> ContinuousBatchingEngine:
        """The first decode shard (the whole stage when unsharded)."""
        return self.decodes[0]

    @property
    def decode_shards(self) -> int:
        return len(self.decodes)

    # --- token relay: every stage emits through one hook --------------
    @property
    def on_token(self):
        return self._on_token

    @on_token.setter
    def on_token(self, fn) -> None:
        self._on_token = fn
        self.prefill.on_token = fn         # the first token, at the handoff
        for eng in self.decodes:
            eng.on_token = fn              # everything after

    # --- stage relay: prefill emits admit/prefill_chunk/handoff, the
    # shards import/decode_step/replay, each tagged with its shard index --
    @property
    def on_stage(self):
        return self._on_stage

    @on_stage.setter
    def on_stage(self, fn) -> None:
        self._on_stage = fn
        self.prefill.on_stage = fn
        for i, eng in enumerate(self.decodes):
            if fn is None:
                eng.on_stage = None
            else:
                def relay(stage, t0, t1, rids, attrs, _i=i, _fn=fn):
                    _fn(stage, t0, t1, rids, {**attrs, "shard": _i})
                eng.on_stage = relay

    # --- the engines' API ---------------------------------------------
    @property
    def done(self) -> Dict[int, Request]:
        if len(self.decodes) == 1:
            return self.decodes[0].done
        merged: Dict[int, Request] = {}
        for eng in self.decodes:
            merged.update(eng.done)
        return merged

    @property
    def pending(self) -> int:
        return (len(self.queue) + (self._parked is not None)
                + (self._restore_parked is not None)
                + sum(e.pending for e in self.decodes))

    # --- radiation hardening: fault API and counters ------------------
    @property
    def harden(self) -> bool:
        return all(e.harden for e in self.decodes)

    def inject_handoff_loss(self) -> None:
        """Arm one seam upset: the next handoff vanishes between gather
        and import and is re-requested."""
        self._lose_handoffs += 1

    def inject_handoff_corruption(self) -> None:
        """Arm one in-transit upset: a byte of the next wire frame flips;
        its checksum catches it and the seam re-requests the handoff."""
        self._corrupt_wire += 1

    def arm_bitflip(self, seed: int = 0) -> None:
        # live KV lives in the decode pools (prefill rows free at gather)
        self.decodes[0].arm_bitflip(seed)

    def stall_slot(self, slot: int) -> None:
        self.decodes[0].stall_slot(slot)

    def unstall_slot(self, slot: int) -> None:
        self.decodes[0].unstall_slot(slot)

    def scrub(self, budget: Optional[int] = None) -> int:
        n = self.prefill.scrub(budget)
        for eng in self.decodes:
            n += eng.scrub(budget)
        return n

    def _summed(self, name: str):
        return getattr(self.prefill, name) + sum(getattr(e, name)
                                                 for e in self.decodes)

    @property
    def bitflips_detected(self) -> int:
        return self._summed("bitflips_detected")

    @property
    def blocks_quarantined(self) -> int:
        return self._summed("blocks_quarantined")

    @property
    def watchdog_trips(self) -> int:
        return self._summed("watchdog_trips")

    @property
    def replays(self) -> int:
        return self._summed("replays")

    @property
    def scrubbed_blocks(self) -> int:
        return self._summed("scrubbed_blocks")

    @property
    def total_tokens(self) -> int:
        return self._summed("total_tokens")

    @property
    def prefix_hits(self) -> int:
        return self._summed("prefix_hits")

    @property
    def prefix_lookups(self) -> int:
        return self._summed("prefix_lookups")

    @property
    def occupancy(self) -> float:
        slots = sum(e.max_slots for e in self.decodes)
        busy = sum(e.occupancy * e.max_slots for e in self.decodes)
        return busy / slots

    @property
    def decode_steps(self) -> int:
        return sum(e.decode_steps for e in self.decodes)

    @property
    def decode_tokens(self) -> int:
        return sum(e.decode_tokens for e in self.decodes)

    @property
    def decode_s(self) -> float:
        return sum(e.decode_s for e in self.decodes)

    @property
    def prefill_tokens(self) -> int:
        return self.prefill.prefill_tokens

    @property
    def admit_s(self) -> float:
        return self.prefill.admit_s

    @property
    def deferrals(self) -> int:
        return self._summed("deferrals") + self._seam_deferrals

    def padded_prompt_len(self, s: int) -> int:
        # the prefill engine's chunk grid sets the padded length crossing
        # the seam (its chunks may be wider than the decode bucket)
        c = self.prefill.prefill_chunk
        return -(-max(s, self.prefill.prompt_len) // c) * c

    def submit(self, req: Request) -> None:
        _require_prompt(req, "engine")
        padded = self.padded_prompt_len(int(req.prompt.shape[0]))
        budget = min(e.table_width * e.block_size for e in self.decodes)
        assert padded + req.max_new <= budget, \
            (req.rid, req.prompt.shape[0], req.max_new, self.max_len)
        self.queue.append(req)

    # --- shard lifecycle ----------------------------------------------
    def retire_shard(self, idx: int) -> None:
        """Drain decode shard ``idx``: it leaves the import rotation now
        but keeps stepping until its streams finish (none is dropped)."""
        if not 0 <= idx < len(self.decodes):
            raise IndexError(f"no decode shard {idx}")
        live = [i for i in range(len(self.decodes))
                if i not in self._draining]
        if live == [idx]:
            raise ValueError("cannot retire the last live decode shard")
        self._draining.add(idx)

    def _import_order(self) -> List[int]:
        """Live shards, least-loaded first, ties by index (deterministic
        routing)."""
        live = [i for i in range(len(self.decodes))
                if i not in self._draining]
        return sorted(live, key=lambda i: (self.decodes[i].pending, i))

    def _transport(self, handoff: PrefillHandoff) -> PrefillHandoff:
        """Cross the seam: serialize to the wire frame and parse it back,
        as a process or host boundary would.  An armed in-transit upset
        flips one payload byte, which the frame checksum turns into
        :class:`HandoffCorruptError` before any block is pasted."""
        wire = handoff.to_bytes()
        if self._corrupt_wire > 0:
            self._corrupt_wire -= 1
            wire = wire[:-1] + bytes([wire[-1] ^ 0x40])
        return PrefillHandoff.from_bytes(wire)

    def _rerequest(self, req: Request) -> None:
        """Queue a lost or corrupted handoff's request again, its first
        token muted: it streamed with the original."""
        self.handoffs_replayed += 1
        self.prefill.mute_rids.add(req.rid)
        self.queue.insert(0, req)

    def step(self) -> List[Request]:
        """Move work across the seam, then run one decode step on every
        shard.  Queued requests are prefilled (stage 1) and imported into
        the least-loaded live shard (stage 2) while blocks and slots allow;
        the first token streams from the prefill stage, the importing
        shard resumes at token index 1."""
        completed: List[Request] = []
        self._drain_restores()             # recovery before fresh work
        while True:
            if self._parked is None:
                if not self.queue:
                    break
                try:
                    ho = self.prefill.prefill_handoff(self.queue[0])
                except OutOfBlocksError:
                    self._seam_deferrals += 1
                    break
                req = self.queue.pop(0)
                if self._lose_handoffs > 0:
                    # an armed seam upset: the payload vanishes in transit
                    self._lose_handoffs -= 1
                    self.handoffs_lost += 1
                    self._rerequest(req)
                    continue
                try:
                    ho = self._transport(ho)
                except HandoffCorruptError:
                    self._rerequest(req)
                    continue
                self._parked = (req, ho)
            req, ho = self._parked
            placed = corrupt = False
            done = None
            for si in self._import_order():
                try:
                    done = self.decodes[si].import_prefill(req, ho)
                except OutOfBlocksError:
                    self.seam_deferrals_by_shard[f"shard{si}"] += 1
                    continue               # next-least-loaded shard
                except HandoffCorruptError:
                    corrupt = True         # no shard can import it
                    break
                placed = True
                break
            if corrupt:
                self._parked = None
                self._rerequest(req)
                continue
            if not placed:
                self._seam_deferrals += 1  # every live shard deferred
                break
            self._parked = None
            self.handoff_count += 1
            self.imports_by_shard[f"shard{si}"] += 1
            if done is not None:
                completed.append(done)
        for eng in self.decodes:           # draining shards step too
            completed += eng.step()
        return completed

    def _drain_restores(self) -> None:
        """Replay shard evictions across the seam: re-run the handoff
        (muted), import it into a healthy slot of the same shard and replay
        the recorded tokens.  A restore that cannot place yet parks with
        its handoff and retries next step without another prefill."""
        while (self._restore_parked is not None
               or any(e._restore_queue for e in self.decodes)):
            if self._restore_parked is None:
                si = next(i for i, e in enumerate(self.decodes)
                          if e._restore_queue)
                eng = self.decodes[si]
                req, gen = eng._restore_queue[0]
                self.prefill.mute_rids.add(req.rid)
                try:
                    ho = self.prefill.prefill_handoff(req)
                except OutOfBlocksError:
                    self.prefill.mute_rids.discard(req.rid)
                    self._seam_deferrals += 1
                    return
                eng._restore_queue.pop(0)
                try:
                    ho = self._transport(ho)
                except HandoffCorruptError:
                    self.handoffs_replayed += 1
                    eng._restore_queue.insert(0, (req, gen))
                    continue
                self._restore_parked = (si, req, gen, ho)
            si, req, gen, ho = self._restore_parked
            eng = self.decodes[si]
            try:
                eng.restore_import(req, gen, ho)
            except HandoffCorruptError:
                self._restore_parked = None
                self.handoffs_replayed += 1
                eng._restore_queue.insert(0, (req, gen))
                continue
            except OutOfBlocksError:
                self._seam_deferrals += 1
                return
            self._restore_parked = None
            eng.replays += 1

    def flush(self) -> List[Request]:
        """Blocking form: run until at least one request completes."""
        if not self.pending:
            return []
        while True:
            done = self.step()
            if done:
                return done

    def stats(self) -> Dict[str, float]:
        shard_stats = [e.stats() for e in self.decodes]
        p = self.prefill.stats()
        d = dict(shard_stats[0])
        for s in shard_stats[1:]:
            for key, val in s.items():
                d[key] += val
        # mean occupancy does not sum: weight each shard's by its steps
        steps = sum(s["decode_steps"] for s in shard_stats)
        d["mean_occupancy"] = (
            sum(s["mean_occupancy"] * s["decode_steps"]
                for s in shard_stats) / steps if steps
            else shard_stats[0]["mean_occupancy"])
        d["total_tokens"] = self.total_tokens
        d["prefill_tokens"] = p["prefill_tokens"]
        d["admit_s"] = p["admit_s"]            # the prefill stage's time
        d["shared_block_hits"] += p["shared_block_hits"]
        d["shared_block_lookups"] += p["shared_block_lookups"]
        d["deferrals"] = self.deferrals
        d["handoffs"] = self.handoff_count
        for key in ("bitflips_detected", "blocks_quarantined",
                    "watchdog_trips", "replays", "scrubbed_blocks"):
            d[key] = getattr(self, key)    # prefill + shards
        d["handoffs_lost"] = self.handoffs_lost
        d["handoffs_replayed"] = self.handoffs_replayed
        d["decode_shards"] = len(self.decodes)
        d["imports_by_shard"] = dict(self.imports_by_shard)
        d["seam_deferrals_by_shard"] = dict(self.seam_deferrals_by_shard)
        return d

    def reset_stats(self) -> None:
        self.prefill.reset_stats()
        for eng in self.decodes:
            eng.reset_stats()
        self._seam_deferrals = 0
        self.handoff_count = 0
        self.handoffs_lost = 0
        self.handoffs_replayed = 0
        self.imports_by_shard = {
            f"shard{i}": 0 for i in range(len(self.decodes))}
        self.seam_deferrals_by_shard = {
            f"shard{i}": 0 for i in range(len(self.decodes))}


# ---------------------------------------------------------------------------
# The windowed loop, and the engine-with-windowed-fallback policy
# ---------------------------------------------------------------------------
class WindowedBaselineServer:
    """The windowed batching loop (greedy-only).  Serves the stacks paged
    decode cannot: recurrent and hybrid mixers, sliding windows, int8
    KV.  It runs on one device: inside a model group of several ranks it
    would compute part of the heads and pick tokens from part of the
    vocab, so a step there raises."""

    def __init__(self, params, cfg: ModelConfig,
                 plan: Optional[PartitionPlan] = None, tp: int = 1,
                 max_batch: int = 8, prompt_len: int = 32,
                 max_len: int = 64, device="cuda"):
        self.params, self.cfg, self.plan, self.tp = params, cfg, plan, tp
        self.device = torch.device(device)
        self.max_batch, self.prompt_len, self.max_len = (max_batch,
                                                         prompt_len, max_len)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._active: Optional[_ActiveWindow] = None
        self.reset_stats()

    def reset_stats(self) -> None:
        self.total_tokens = 0             # real sampled tokens only
        self.decode_steps = 0
        self.decode_tokens = 0            # tokens produced by decode steps
        self.decode_s = 0.0               # wall time inside decode steps
        self.prefill_tokens = 0           # prompt tokens prefilled
        self.deferrals = 0                # windowed loop never defers

    def submit(self, req: Request) -> None:
        _require_prompt(req, "server")
        assert req.prompt.shape[0] <= self.prompt_len
        assert self.prompt_len + req.max_new <= self.max_len, \
            (req.rid, req.max_new, self.max_len)
        if req.sampling is not None and not req.sampling.greedy:
            warnings.warn(
                f"request {req.rid}: the windowed baseline decodes "
                f"greedily and ignores SamplingParams")
        self.queue.append(req)

    @property
    def pending(self) -> int:
        """Requests admitted but not yet completed (queued + in-window)."""
        return len(self.queue) + (len(self._active.batch)
                                  if self._active else 0)

    @property
    def occupancy(self) -> float:
        """Fraction of batch slots doing useful work right now."""
        if self._active is None:
            return 0.0
        return len(self._active.batch) / self.max_batch

    def step(self) -> List[Request]:
        """Advance by one unit of work and return requests it completed.

        No active window: start one (prefill + first token) from the queue.
        Active window: run one decode step.  Returns [] until the window's
        last decode step, at which point the whole batch is finalized.
        """
        if collectives.model_ranks() > 1:
            raise ValueError(f"the windowed server runs on one device; it is "
                             f"inside a model group of "
                             f"{collectives.model_ranks()} ranks")
        if self._active is None:
            if not self.queue:
                return []
            self._start_window()
        else:
            w = self._active
            t0 = time.perf_counter()
            out = T.decode_step(self.params, self.cfg, w.last, w.cache,
                                self.plan, self.tp)
            w.cache = out.cache
            w.last = torch.argmax(out.logits[:, -1], dim=-1)[:, None].int()
            w.gen.append(w.last.cpu().numpy())
            self.decode_s += time.perf_counter() - t0
            w.remaining -= 1
            w.steps_done += 1
            self.decode_steps += 1
            # padding rows past a request's own max_new are not tokens
            useful = sum(1 for r in w.batch if w.steps_done <= r.max_new - 1)
            self.decode_tokens += useful
            self.total_tokens += useful
        return self._finish_if_done()

    def flush(self) -> List[Request]:
        """Serve one bounded window to completion (blocking form of step)."""
        if self._active is None and not self.queue:
            return []
        while True:
            batch = self.step()
            if batch:
                return batch

    def stats(self) -> Dict[str, float]:
        return {"total_tokens": self.total_tokens,
                "decode_steps": self.decode_steps,
                "decode_tokens": self.decode_tokens,
                "decode_s": self.decode_s,
                "prefill_tokens": self.prefill_tokens,
                "deferrals": self.deferrals}

    def _start_window(self) -> None:
        batch = self.queue[:self.max_batch]
        self.queue = self.queue[self.max_batch:]
        b = self.max_batch                        # fixed bucket shape
        toks = np.zeros((b, self.prompt_len), np.int32)
        for i, r in enumerate(batch):
            toks[i, -r.prompt.shape[0]:] = r.prompt   # left-pad
        cache = T.init_cache(self.cfg, b, self.max_len, self.tp,
                             device=self.device)
        out = T.prefill(self.params, self.cfg,
                        torch.as_tensor(toks, device=self.device), cache,
                        self.plan, self.tp)
        last = torch.argmax(out.logits[:, -1], dim=-1)[:, None].int()
        max_new = max(r.max_new for r in batch)
        self.prefill_tokens += self.prompt_len * len(batch)
        self.total_tokens += sum(1 for r in batch if r.max_new >= 1)
        self._active = _ActiveWindow(batch, out.cache, last,
                                     [last.cpu().numpy()], max_new - 1)

    def _finish_if_done(self) -> List[Request]:
        w = self._active
        if w is None or w.remaining > 0:
            return []
        gen = np.concatenate(w.gen, axis=1)       # [b, max(max_new, 1)]
        for i, r in enumerate(w.batch):
            r.output = gen[i, :r.max_new]
            self.done[r.rid] = r
        self._active = None
        return w.batch


def engine_or_windowed(params, cfg: ModelConfig,
                       plan: Optional[PartitionPlan] = None, tp: int = 1,
                       max_slots: int = 8, prompt_len: int = 32,
                       max_len: int = 64, block_size: int = 8,
                       num_blocks: Optional[int] = None,
                       prefill_chunk: Optional[int] = None,
                       harden: bool = False, watchdog_steps: int = 8,
                       scrub_blocks: int = 2,
                       on_fallback: Optional[Callable[[Exception], None]]
                       = None, device="cuda"):
    """The one engine-with-windowed-fallback policy.

    Constructs a :class:`ContinuousBatchingEngine`; stacks paged decode
    cannot serve (recurrent and hybrid mixers, sliding windows, int8 KV —
    the engine raises ``ValueError``) fall back to the windowed loop, after
    calling ``on_fallback(exc)`` if given.  ``harden``, ``watchdog_steps``
    and ``scrub_blocks`` tune the engine's hardened serving; the windowed
    loop takes none of them, as in the reference.
    """
    if max_len > prompt_len:
        try:
            return ContinuousBatchingEngine(
                params, cfg, plan=plan, tp=tp, max_slots=max_slots,
                prompt_len=prompt_len, max_len=max_len,
                block_size=block_size, num_blocks=num_blocks,
                prefill_chunk=prefill_chunk, harden=harden,
                watchdog_steps=watchdog_steps, scrub_blocks=scrub_blocks,
                device=device)
        except ValueError as e:    # non-pageable: keep the windowed loop
            if on_fallback is not None:
                on_fallback(e)
    return WindowedBaselineServer(params, cfg, plan=plan, tp=tp,
                                  max_batch=max_slots,
                                  prompt_len=prompt_len, max_len=max_len,
                                  device=device)


def BatchingServer(params, cfg: ModelConfig,
                   plan: Optional[PartitionPlan] = None, tp: int = 1,
                   max_batch: int = 8, prompt_len: int = 32,
                   max_len: int = 64, device="cuda"):
    """Deprecated windowed-server entry point: warns and forwards to
    :func:`engine_or_windowed`."""
    warnings.warn(
        "BatchingServer is deprecated; serve through engine_or_windowed. "
        "Forwarding to the continuous-batching engine.", DeprecationWarning,
        stacklevel=2)
    return engine_or_windowed(params, cfg, plan=plan, tp=tp,
                              max_slots=max_batch, prompt_len=prompt_len,
                              max_len=max_len, device=device)
