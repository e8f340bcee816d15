"""Slot-based continuous batching over a paged KV pool (the port of
``repro.runtime.serve.ContinuousBatchingEngine``).

A fixed set of *slots* shares a paged KV pool (``runtime/paging.py``).  A
request is admitted into any free slot the moment enough KV blocks exist
(its whole ``prompt_len + max_new`` budget is reserved up front, so a
running request can never strand mid-decode); it decodes for *exactly* its
own ``max_new`` steps; the step it finishes, its blocks free and its slot
is re-admittable.  Admission that would overcommit the pool raises
:class:`~repro_torch.runtime.paging.OutOfBlocksError` internally; the
request waits in the queue and the deferral is counted.  Attention runs
the paged-decode kernel (``kernels/paged_attention.py``), and the int8
segments of an ``"mpai"`` plan run the int8 GEMM kernel.

Decoding is greedy (``argmax``, ties to the lowest index, as in the
reference).  Sampled requests, hardening (``harden=True``) and the
prefill handoff are later slices of the port and raise
``NotImplementedError``.

Progress: ``step()`` admits into free slots and runs one decode step;
``flush()`` runs until at least one request completes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.tree import tree_map
from repro_torch.models import transformer as T
from repro_torch.runtime import paging
from repro_torch.runtime.paging import BlockAllocator, OutOfBlocksError
from repro_torch.runtime.sampling import SamplingParams


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


_DEFER = object()        # admission verdict: blocks unavailable, retry later


def _require_prompt(req: Request, who: str) -> None:
    """Reject empty prompts up front: a zero-length prompt would select the
    whole bucket row when left-padded."""
    if req.prompt.shape[0] == 0:
        raise ValueError(
            f"request {req.rid}: empty prompt — the {who} needs at "
            f"least one prompt token to prefill")


class ContinuousBatchingEngine:
    """Slot-based continuous-batching decode over a paged KV pool.

    ``max_slots`` batch slots share a pool of ``num_blocks`` KV blocks of
    ``block_size`` tokens.  One ``step()`` = admissions (one fused bucket
    prefill + paste for every short prompt of the round, chunked paged
    prefill for each long one) + one batched decode step for every
    occupied slot.

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
                 harden: bool = False, device="cuda"):
        if harden:
            raise NotImplementedError("hardened serving is not ported yet")
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
        self.caches = T.init_paged_decode_cache(
            cfg, max_slots, num_blocks, block_size, tp,
            max_blocks=self.table_width, device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.last = np.zeros((max_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._dirty = True                    # host table/lengths changed
        self.on_token: Optional[Callable[[int, int], None]] = None
        self.on_stage = None
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
        if req.sampling is not None and not req.sampling.greedy:
            raise NotImplementedError(
                f"request {req.rid}: sampled decoding (temperature > 0) is "
                f"not ported yet; the port decodes greedily")
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
        """Requests admitted but not yet completed (queued + in-slot)."""
        return len(self.queue) + sum(s is not None for s in self.slots)

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
        requests outright — their single token comes from prefill)."""
        completed = self._admit()
        completed += self._decode_once()
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
        # the hardening counters keep the reference's telemetry keys; they
        # stay 0 until hardened serving is ported
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
                "bitflips_detected": 0,
                "blocks_quarantined": 0,
                "watchdog_trips": 0,
                "replays": 0,
                "scrubbed_blocks": 0}

    def prefill_handoff(self, req: Request):
        raise NotImplementedError("the prefill handoff is not ported yet")

    def import_prefill(self, req: Request, handoff):
        raise NotImplementedError("the prefill handoff is not ported yet")

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _admit_step(self, toks: np.ndarray, admit: np.ndarray) -> np.ndarray:
        """One admission round: bucket-shaped prefill, paste of every
        admitted row's KV into its paged blocks (non-admitted rows scatter
        to the trash row), and the first greedy token per row."""
        out = T.prefill(self.params, self.cfg, self._tensor(toks),
                        self._prefill_cache, self.plan, self.tp)
        admit_t = self._tensor(admit)
        for key, st in self.caches.items():
            dc = out.cache[key]
            for layer in range(st.k_pool.shape[0]):
                paging.write_prefill_batch(tree_map(lambda a: a[layer], st),
                                           dc.k[layer], dc.v[layer], admit_t)
        return torch.argmax(out.logits[:, -1], dim=-1).cpu().numpy()

    def _push_tables(self) -> None:
        """Copy the host table/length mirrors into every layer's cache."""
        tbl, lens = self._tensor(self.table), self._tensor(self.lengths)
        for st in self.caches.values():
            st.block_table.copy_(tbl.expand_as(st.block_table))
            st.lengths.copy_(lens.expand_as(st.lengths))

    def _emit(self, rid: int, tok: int) -> None:
        if self.on_token is not None:
            self.on_token(rid, tok)

    def _stage(self, stage: str, t0: float, t1: float, rids, **attrs):
        if self.on_stage is not None:
            self.on_stage(stage, t0, t1, list(rids), attrs)

    def _admit(self) -> List[Request]:
        admits: List[tuple] = []
        completed: List[Request] = []
        for i in range(self.max_slots):
            if not self.queue:
                break
            if self.slots[i] is not None:
                continue
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
        for i, req in admits:
            toks[i, -req.prompt.shape[0]:] = req.prompt      # left-pad
            admit[i] = True
        t0 = time.perf_counter()
        firsts = self._admit_step(toks, admit)
        t1 = time.perf_counter()
        self.admit_s += t1 - t0
        self._stage("admit", t0, t1, [req.rid for _, req in admits],
                    tokens=self.prompt_len * len(admits))
        for i, req in admits:
            self.lengths[i] = self.prompt_len
            self.prefill_tokens += self.prompt_len
            tok = int(firsts[i])
            if req.max_new >= 1:
                # a max_new=0 request emits nothing and counts no token
                self.total_tokens += 1
                self._emit(req.rid, tok)
            if req.max_new <= 1:       # done at admission (0 => empty)
                completed.append(
                    self._finalize(i, req, [tok][:req.max_new]))
            else:
                self.slots[i] = _Slot(req, [tok], req.max_new - 1)
                self.last[i, 0] = tok
        return completed

    def _run_chunks(self, i: int, padded: np.ndarray, first_chunk: int,
                    rid: Optional[int] = None) -> int:
        """Run ``padded``'s chunks from ``first_chunk`` on through chunked
        paged prefill; returns the final chunk's greedy token."""
        c = self.prefill_chunk
        t0 = ct0 = time.perf_counter()
        first = None
        for ci in range(first_chunk, padded.shape[0] // c):
            out = T.prefill_paged_chunk(
                self.params, self.cfg,
                self._tensor(padded[ci * c:(ci + 1) * c][None]),
                self.caches, i, ci * c, self.plan, self.tp)
            first = torch.argmax(out.logits[0, -1])
            if self.on_stage is not None:
                ct1 = time.perf_counter()
                self._stage("prefill_chunk", ct0, ct1, [rid],
                            chunk=ci, tokens=c)
                ct0 = ct1
        tok = int(first)
        self.admit_s += time.perf_counter() - t0
        self.prefill_tokens += padded.shape[0] - first_chunk * c
        return tok

    def _admit_chunked(self, i: int, req: Request):
        """Admit one over-bucket prompt into slot ``i`` via chunked paged
        prefill.

        The prompt is left-padded to a whole number of prefill chunks, its
        full block budget (padded prompt + max_new) reserved atomically,
        and each chunk runs one prefill+paste call.  Before allocating,
        the content-hashed :class:`~repro_torch.runtime.paging.
        SharedBlockIndex` is consulted: a live identical prompt prefix
        (whole chunks only — the final chunk always recomputes, its
        last-token logits pick the first token) is reference-shared
        instead of re-prefilled.  Returns the completed Request for
        ``max_new<=1``, None when the request now occupies the slot, or
        ``_DEFER`` when the pool cannot cover it yet (nothing leaks)."""
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
            return _DEFER
        self._push_tables()
        self._dirty = False
        tok = self._run_chunks(i, padded, shared_blocks * bs // c,
                               rid=req.rid)
        # publish the freshly prefilled prompt blocks for future sharers
        # (all are full, read-only blocks: decode appends start a new
        # block because the padded length is block-aligned)
        for b in range(shared_blocks, n_prompt_blocks):
            self.shared.register(digests[b], int(self.table[i, b]))
        self.lengths[i] = length
        if req.max_new >= 1:
            self.total_tokens += 1
            self._emit(req.rid, tok)
        if req.max_new <= 1:
            return self._finalize(i, req, [tok][:req.max_new])
        self.slots[i] = _Slot(req, [tok], req.max_new - 1)
        self.last[i, 0] = tok
        return None

    def _decode_once(self) -> List[Request]:
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        if self._dirty:
            self._push_tables()
            self._dirty = False
        t0 = time.perf_counter()
        out = T.decode_step(self.params, self.cfg, self._tensor(self.last),
                            self.caches, self.plan, self.tp)
        nxt = torch.argmax(out.logits[:, -1], dim=-1).cpu().numpy()
        t1 = time.perf_counter()
        self.decode_s += t1 - t0
        self._stage("decode_step", t0, t1,
                    [self.slots[i].req.rid for i in active],
                    step=self.decode_steps, tokens=len(active))
        completed: List[Request] = []
        for i in active:
            self.lengths[i] += 1           # mirror device append_tokens
            s = self.slots[i]
            tok = int(nxt[i])
            s.gen.append(tok)
            s.remaining -= 1
            self.last[i, 0] = tok
            self._emit(s.req.rid, tok)
            if s.remaining <= 0:
                completed.append(self._finalize(i, s.req, s.gen))
                self.slots[i] = None
        self.decode_steps += 1
        self.total_tokens += len(active)
        self.decode_tokens += len(active)
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
