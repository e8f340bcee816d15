"""Engine-backed pool executor: adapts an LM server to the router (the
port of ``repro.serving.executor``; it submits the port's
``runtime.serve.Request``).

:class:`EngineExecutor` is the bridge between the routing fabric
(``router/pool.py`` calls ``executor.run(plan, batch)`` and gets back
``(latency_s, energy_j)``) and a real decode server — the
:class:`~repro_torch.runtime.serve.ContinuousBatchingEngine` by preference,
or the windowed baseline for comparison runs.  Beyond the old
``ServerExecutor`` it:

* understands :class:`LMWork` payloads (per-request ``max_new`` and
  :class:`~repro_torch.runtime.sampling.SamplingParams`), not just raw prompt
  arrays;
* relays the engine's per-token callback upward (rid, token, engine
  decode step) — the feed for ``ResponseHandle.stream()``;
* records *decode-only* telemetry into the pool's counters
  (``decode_tokens`` / ``decode_s`` deltas around each batch), so
  ``tokens/s`` in snapshots is decode throughput, not
  prefill-window-idle-time-diluted throughput — consistent with
  ``benchmarks/decode_bench.py``;
* surfaces the engine's ``OutOfBlocksError`` admission deferrals as a
  backpressure counter (``deferrals``) in the same snapshot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.scheduler import ScheduledPlan
from repro_torch.router.pool import RouterRequest
from repro_torch.router.telemetry import PoolCounters
from repro_torch.runtime.sampling import SamplingParams


@dataclass
class LMWork:
    """One LM request flowing through the facade: prompt in, tokens out."""
    prompt: np.ndarray
    max_new: Optional[int] = None        # None -> the pool's default
    sampling: Optional[SamplingParams] = None
    output: Optional[np.ndarray] = None
    # disaggregated pools stamp which stage pool prefilled the prompt
    # (None on unified pools; the routed pool itself decodes either way)
    prefill_pool: Optional[str] = None


class EngineExecutor:
    """Execute a routed batch on a real LM server (continuous-batching
    engine or the windowed baseline — same submit/step/done API).

    Request payloads are :class:`LMWork` (or bare token prompts); the
    batch is submitted and driven to completion with the server's
    non-blocking ``step()``.  Latency is measured wall time; energy is
    the plan's nominal per-inference estimate scaled by the tokens the
    batch actually decoded (decode-only, matching decode_tokens_per_s).
    Given ``counters`` (the pool's PoolCounters — the same object
    Telemetry reads) it records decode telemetry: tokens generated,
    slot occupancy after every step, and decode-only token/time deltas.
    """

    def __init__(self, server, max_new: int = 8,
                 counters: Optional[PoolCounters] = None,
                 on_token: Optional[Callable[[int, int, int], None]] = None,
                 prefill_pool: Optional[str] = None,
                 prefill_counters: Optional[PoolCounters] = None,
                 prefill_energy_scale: float = 0.5):
        self.server = server
        self.max_new = max_new
        self.counters = counters
        self.on_token = on_token             # (rid, token, engine_step)
        # disaggregated (CoProcServer) pools: the prefill stage's own
        # telemetry identity — its counters are charged here (tokens
        # prefilled, stage wall time, energy at the DPU-analogue's
        # discounted per-token rate) and registered with the router so
        # the fleet snapshot and orbit energy bucket see both stages
        self.prefill_pool = prefill_pool
        self.prefill_counters = prefill_counters
        self.prefill_energy_scale = prefill_energy_scale
        # flight recorder: the Router wires the fleet's shared tracer
        # and this pool's name in; engine stage events (admit, prefill
        # chunks, handoff, import, decode steps) are relayed into it
        # while a traced batch runs
        self.tracer = None
        self.pool_name = None
        if hasattr(server, "on_token"):
            server.on_token = self._relay

    def _relay(self, rid: int, tok: int) -> None:
        if self.on_token is not None:
            self.on_token(rid, tok, getattr(self.server, "decode_steps", 0))

    def _stats(self) -> Tuple[int, float, int, int, float]:
        s = self.server
        return (getattr(s, "decode_tokens", 0),
                getattr(s, "decode_s", 0.0),
                getattr(s, "deferrals", 0),
                getattr(s, "prefill_tokens", 0),
                getattr(s, "admit_s", 0.0))

    def _hstats(self) -> Tuple[int, int, int, int]:
        """Hardening counters (zero on servers without the layer)."""
        s = self.server
        return (getattr(s, "bitflips_detected", 0),
                getattr(s, "blocks_quarantined", 0),
                getattr(s, "watchdog_trips", 0),
                getattr(s, "handoffs_replayed", 0))

    def _sstats(self) -> Tuple[int, int, Dict[str, int]]:
        """Seam/sharing counters: prefix-index traffic and per-shard
        handoff imports (empty on unsharded/paged-less servers)."""
        s = self.server
        return (getattr(s, "prefix_hits", 0),
                getattr(s, "prefix_lookups", 0),
                dict(getattr(s, "imports_by_shard", {}) or {}))

    def _install_stage_relay(self, plan: ScheduledPlan, now: float,
                             wall0: float) -> bool:
        """While this batch runs, forward the engine's ``on_stage``
        events into the tracer, anchoring wall perf_counter times at the
        batch's *virtual* launch instant ``now`` — engine sub-spans
        (chunks, decode steps) then nest inside the pool's virtual
        ``serve`` span.  Per-request stages (prefill chunks, the
        handoff, the import) record under their rid; batch-wide stages
        (fused admit, decode steps) are pool-lane spans (rid=None).
        Disaggregated pools put prefill-side stages on the prefill stage
        pool's lane and stamp each chunk's energy at the discounted
        per-token rate, so summed chunk energy equals the stage
        counters' charge exactly."""
        tr = self.tracer
        if (tr is None or not tr.enabled
                or not hasattr(self.server, "on_stage")):
            return False
        decode_pool = self.pool_name
        pre_pool = self.prefill_pool or decode_pool
        chunk_e = (plan.energy_j * self.prefill_energy_scale
                   if self.prefill_counters is not None else None)

        def relay(stage, w0, w1, rids, attrs):
            vt0, vt1 = now + (w0 - wall0), now + (w1 - wall0)
            if stage in ("admit", "decode_step",
                         "seu_bitflip", "bitflip_detected"):
                # batch-wide (or block-level, rid-less) events live on
                # the pool lane
                tr.add(None, stage, vt0, vt1, pool=decode_pool,
                       rids=len(rids), **attrs)
                return
            pool = pre_pool if stage in ("prefill_chunk",
                                         "handoff") else decode_pool
            extra = ({} if chunk_e is None or stage != "prefill_chunk"
                     else {"energy_j": chunk_e * attrs.get("tokens", 0)})
            for rid in rids:
                tr.add(rid, stage, vt0, vt1, pool=pool, **attrs, **extra)

        self.server.on_stage = relay
        return True

    def run(self, plan: ScheduledPlan, requests: Sequence[RouterRequest],
            now: float = 0.0) -> Tuple[float, float]:
        from repro_torch.runtime.serve import Request as ServeRequest
        t0 = time.perf_counter()
        traced = self._install_stage_relay(plan, now, t0)
        tok0, dec0, def0, pre0, adm0 = self._stats()
        h0 = self._hstats()
        px0, pl0, sh0 = self._sstats()
        want = {}
        for r in requests:
            work = (r.payload if isinstance(r.payload, LMWork)
                    else LMWork(np.asarray(r.payload, np.int32)))
            r.payload = work
            if r.rid in self.server.done:
                # failover re-dispatch of a batch this server already
                # ran to completion: hand back the finished output
                # instead of decoding (and emitting tokens) twice
                work.output = self.server.done[r.rid].output
                continue
            max_new = self.max_new if work.max_new is None else work.max_new
            pad_fn = getattr(self.server, "padded_prompt_len", None)
            if pad_fn is None:             # windowed baseline: hard bucket
                if work.prompt.shape[0] > self.server.prompt_len:
                    raise ValueError(
                        f"request {r.rid}: prompt of "
                        f"{work.prompt.shape[0]} tokens exceeds this "
                        f"windowed pool's prompt_len bucket of "
                        f"{self.server.prompt_len}; route it to an "
                        f"engine pool (chunked paged prefill lifts the "
                        f"bucket limit)")
                padded = self.server.prompt_len
            else:
                padded = pad_fn(int(work.prompt.shape[0]))
            if padded + max_new > self.server.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({work.prompt.shape[0]} "
                    f"tokens, {padded} padded) + max_new={max_new} "
                    f"exceeds this pool's max_len={self.server.max_len} "
                    f"(PoolSpec max_prompt_len/max_new size the KV "
                    f"allocation; raise them or shrink the request)")
            work.prefill_pool = self.prefill_pool
            want[r.rid] = work
            self.server.submit(ServeRequest(r.rid, work.prompt,
                                            max_new=max_new,
                                            sampling=work.sampling))
        while not all(rid in self.server.done for rid in want):
            self.server.step()
            if self.counters is not None and hasattr(self.server,
                                                     "occupancy"):
                self.counters.slot_occupancy.record(self.server.occupancy)
        for rid, work in want.items():
            work.output = self.server.done[rid].output
        tok1, dec1, def1, pre1, adm1 = self._stats()
        h1 = self._hstats()
        if self.counters is not None:
            self.counters.tokens_generated += sum(
                int(w.output.shape[0]) for w in want.values())
            self.counters.decode_tokens += tok1 - tok0
            self.counters.decode_s += dec1 - dec0
            self.counters.deferrals += def1 - def0
            self.counters.bitflips_detected += h1[0] - h0[0]
            self.counters.blocks_quarantined += h1[1] - h0[1]
            self.counters.watchdog_trips += h1[2] - h0[2]
            self.counters.handoffs_replayed += h1[3] - h0[3]
            px1, pl1, sh1 = self._sstats()
            self.counters.prefix_hits += px1 - px0
            self.counters.prefix_lookups += pl1 - pl0
            for shard, n in sh1.items():
                delta = n - sh0.get(shard, 0)
                if delta:
                    self.counters.imports_by_shard[shard] = (
                        self.counters.imports_by_shard.get(shard, 0)
                        + delta)
            if self.prefill_counters is None:
                self.counters.prefill_tokens += pre1 - pre0
        if self.prefill_counters is not None:
            # disaggregated pool: the prefill stage's share of this
            # batch — prompt tokens pushed through the DPU-analogue
            # engine, its wall time, and its energy at the discounted
            # per-token rate — lands on ITS pool counters, never the
            # decode pool's, so snapshots and the orbit bucket attribute
            # each stage's joules to the hardware that spent them
            pc = self.prefill_counters
            pc.dispatched += len(want)
            pc.completed += len(want)
            pc.prefill_tokens += pre1 - pre0
            pc.busy_s += adm1 - adm0
            pc.energy_j += (plan.energy_j * self.prefill_energy_scale
                            * (pre1 - pre0))
        # Energy scales with tokens actually decoded this batch (every
        # decode step is one forward pass priced at the plan's nominal
        # per-inference energy_j) — not with request count, which would
        # charge a max_new=16 request the same as a max_new=1 one and
        # charge failover re-serves (zero decode) all over again.  The
        # decode-only basis matches the pool's decode_tokens_per_s
        # telemetry, so the orbit energy bucket drains against real work.
        if traced:
            self.server.on_stage = None
        return time.perf_counter() - t0, plan.energy_j * (tok1 - tok0)
