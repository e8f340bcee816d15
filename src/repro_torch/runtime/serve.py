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

Decoding is greedy (``argmax``, ties to the lowest index, as in the
reference).  Sampled requests, hardening (``harden=True``) and the
prefill handoff are later slices of the port and raise
``NotImplementedError``.

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

Progress: ``step()`` advances by one unit of work (the engine: admissions
and one decode step; the windowed loop: a window's prefill or one decode
step); ``flush()`` runs until at least one request completes.
"""
from __future__ import annotations

import time
import warnings
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
        # read after the paged cache, as the reference does: a stack paged
        # decode cannot serve raises ValueError above and falls back
        if harden:
            raise NotImplementedError("hardened serving is not ported yet")
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


# ---------------------------------------------------------------------------
# The windowed loop, and the engine-with-windowed-fallback policy
# ---------------------------------------------------------------------------
class WindowedBaselineServer:
    """The windowed batching loop (greedy-only).  Serves the stacks paged
    decode cannot: recurrent and hybrid mixers, sliding windows, int8
    KV."""

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
    and ``scrub_blocks`` tune hardened serving, which the port's engine
    does not run yet: a stack the engine can serve raises
    ``NotImplementedError`` under ``harden=True``; one it cannot falls
    back as without it (the windowed loop takes no ``harden``, as in the
    reference).
    """
    del watchdog_steps, scrub_blocks
    if max_len > prompt_len:
        try:
            return ContinuousBatchingEngine(
                params, cfg, plan=plan, tp=tp, max_slots=max_slots,
                prompt_len=prompt_len, max_len=max_len,
                block_size=block_size, num_blocks=num_blocks,
                prefill_chunk=prefill_chunk, harden=harden, device=device)
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
