"""The serving front door: submit requests, get handles, stream tokens
(the port of ``repro.serving.client``).

:class:`ServingClient` is the single entry point over the whole
heterogeneous fleet (MPAI's one-submission-interface).  It owns the
fleet's clock: ``submit()`` admits a request through the router at the
current virtual time, ``step()`` advances one tick (fault injection +
pool progress), and both :meth:`ResponseHandle.result` and
:meth:`ResponseHandle.stream` drive that clock themselves, so callers
never touch Router/FailoverController directly.

Per-token streaming: engine-backed pools relay every sampled token
(rid, token, engine decode step) the step it is produced; the handle
buffers them, ``stream()`` yields them in order, and the step stamps
let tests assert tokens really arrived incrementally across decode
steps rather than at batch completion.  Pools without a token hook (the
windowed baseline, cost-model pools) backfill the buffer at completion,
so ``stream()``/``result()`` behave identically everywhere — just
without mid-batch granularity.

Radiation hardening: data-plane faults (``kv_bitflip``, ``slot_stall``)
are delivered into the target pool's hardened engine, each tick gives
every hardened engine its budgeted scrub pass, and ``watchdog_s`` adds a
fleet-level no-progress backstop over live handles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.obs.timeseries import FleetTimeSeries
from repro_torch.router import FailoverController, Router, RouterRequest
from repro_torch.router.slo import SLO_CLASSES, SLOClass
from repro_torch.runtime.sampling import SamplingParams
from repro_torch.serving.executor import LMWork


@dataclass
class Response:
    """Terminal record for one request."""
    rid: int
    admitted: bool
    tokens: Optional[np.ndarray]         # None for cost-model requests
    latency_s: Optional[float]
    violated: bool
    dropped: bool
    pool: Optional[str]


class ResponseHandle:
    """Caller's view of one in-flight request."""

    def __init__(self, client: "ServingClient", rreq: RouterRequest,
                 work: Optional[LMWork], admitted: bool):
        self._client = client
        self._rreq = rreq
        self._work = work
        self.admitted = admitted
        self._tokens: List[int] = []
        self._token_steps: List[Optional[int]] = []
        self._reroutes_seen = 0
        self._epoch = 0            # bumps when a reroute clears the buffer

    def _sync_reroute(self) -> None:
        """An SEU destroyed the in-flight decode; the re-dispatched
        request restarts its stream from token 0 on the new pool, so the
        buffer resets before anything else reads or extends it.  Every
        buffer access funnels through here: ``_backfill`` used to slice
        ``output[len(self._tokens):]`` against the STALE pre-reroute
        buffer, silently dropping the re-served stream's first tokens."""
        if self._rreq.rerouted != self._reroutes_seen:
            self._reroutes_seen = self._rreq.rerouted
            self._epoch += 1
            self._tokens.clear()
            self._token_steps.clear()

    # fed by the engine's per-token callback, via the client
    def _push(self, tok: int, step: Optional[int]) -> None:
        self._sync_reroute()
        self._tokens.append(int(tok))
        self._token_steps.append(step)

    def _backfill(self) -> None:
        """Hook-less backends deliver tokens only at completion."""
        self._sync_reroute()
        out = None if self._work is None else self._work.output
        if out is not None:
            for tok in np.asarray(out)[len(self._tokens):]:
                self._push(int(tok), None)

    @property
    def rid(self) -> int:
        return self._rreq.rid

    @property
    def done(self) -> bool:
        return (not self.admitted or self._rreq.dropped
                or self._rreq.done_s is not None)

    @property
    def dropped(self) -> bool:
        return self._rreq.dropped

    @property
    def tokens(self) -> List[int]:
        """Tokens received so far (does not advance the fleet)."""
        self._sync_reroute()       # never expose a stale pre-reroute buffer
        if self.done:
            self._backfill()       # hook-less backends deliver at the end
        return list(self._tokens)

    @property
    def token_steps(self) -> List[Optional[int]]:
        """Engine decode-step stamp per received token (None = delivered
        at completion by a hook-less backend)."""
        self._sync_reroute()
        if self.done:
            self._backfill()
        return list(self._token_steps)

    def result(self, max_s: float = 600.0) -> Response:
        """Drive the fleet until this request completes (or is dropped)."""
        while not self.done:
            self._client.step()
            if self._client.now > max_s:
                raise RuntimeError(f"request {self.rid} did not complete "
                                   f"by t={max_s}s")
        self._backfill()
        r = self._rreq
        tokens = (np.asarray(self._tokens, np.int32)
                  if self._work is not None else None)
        latency = None if r.done_s is None else r.done_s - r.arrival_s
        return Response(r.rid, self.admitted, tokens, latency,
                        violated=r.violated, dropped=r.dropped, pool=r.pool)

    def stream(self, max_s: float = 600.0) -> Iterator[int]:
        """Yield tokens as they arrive, driving the fleet in between.

        Exactly-once across recovery: the cursor counts tokens
        *delivered to the consumer*, and a failover reroute clears the
        buffer while the re-served decode regrows it bit-identically
        (deterministic sampling), so delivery resumes at the first
        not-yet-yielded token — the consumer never sees a duplicate of
        the prefix it already consumed, and never skips a token of the
        re-served tail."""
        i = 0
        while True:
            self._sync_reroute()
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self.done:
                self._backfill()
                while i < len(self._tokens):
                    yield self._tokens[i]
                    i += 1
                return
            self._client.step()
            if self._client.now > max_s:
                raise RuntimeError(f"request {self.rid} stalled at "
                                   f"t={max_s}s")

    def trace(self) -> Optional[Dict]:
        """This request's span tree from the flight recorder (None when
        tracing was off at submission): the root ``request`` span with
        queue/serve/prefill/decode stages nested by containment, plus
        the terminal ``outcome``.  See :mod:`repro_torch.obs`."""
        return self._client.tracer.trace(self.rid)

    @property
    def telemetry(self) -> Dict:
        """Per-request slice of the fleet's bookkeeping."""
        if self.done:
            self._backfill()
        r = self._rreq
        return {
            "rid": r.rid,
            "admitted": self.admitted,
            "pool": r.pool,
            # the co-processing split, per request: a disaggregated pool
            # stamps which stage pool prefilled the prompt; the routed
            # pool itself runs decode (they coincide on unified pools)
            "prefill_pool": (getattr(self._work, "prefill_pool", None)
                             if self._work is not None else None),
            "decode_pool": r.pool,
            "dropped": r.dropped,
            "violated": r.violated,
            "rerouted": r.rerouted,
            "deferred": r.deferred,
            "arrival_s": r.arrival_s,
            "done_s": r.done_s,
            "latency_s": (None if r.done_s is None
                          else r.done_s - r.arrival_s),
            # golden-signal stamps: time to first token the consumer saw
            # (falls back to completion on hook-less pools) and the
            # end-to-end latency under its SLI name
            "ttft_s": (None if r.first_out_s is None
                       else r.first_out_s - r.arrival_s),
            "e2e_s": (None if r.done_s is None
                      else r.done_s - r.arrival_s),
            "tokens": len(self._tokens),
        }


class ServingClient:
    """One front door over the fleet; constructed by ``FleetSpec.build``."""

    def __init__(self, router: Router,
                 failover: Optional[FailoverController] = None,
                 engines: Optional[Dict[str, object]] = None,
                 spec=None, dt: float = 0.002,
                 slo_map: Optional[Dict[str, SLOClass]] = None,
                 model=None, layers=None,
                 watchdog_s: Optional[float] = None, device="cuda"):
        self.router = router
        self.failover = failover
        self.engines = dict(engines or {})   # pool name -> LM server
        self.spec = spec
        self.dt = dt
        self.now = 0.0
        self._next_rid = 0
        self._handles: Dict[int, ResponseHandle] = {}
        self._slos = dict(slo_map or {})
        # live-mutation state: the model/layers new pools are built from,
        # and pools draining toward graceful retirement
        self._model = model                  # (cfg, params) or None
        self.device = device                 # where new LM pools run
        self._layers = layers if layers is not None else list(router.layers)
        self._retiring: set = set()
        # orbit control plane (repro_torch.orbit.FleetController), if
        # attached
        self.controller = None
        # SLO judgment plane (repro_torch.obs.slo.SLOEngine), if attached
        self.slo_engine = None
        # flight recorder: the router's tracer (disabled until
        # enable_tracing) plus the always-on fleet time-series ring
        self.tracer = router.telemetry.tracer
        self.timeseries = FleetTimeSeries()
        # radiation hardening: deliver data-plane fault events into the
        # target pool's engine, and back-stop the engine watchdogs with a
        # fleet-level no-progress check over live handles
        if failover is not None:
            failover.data_plane = self._apply_data_plane_fault
        self.watchdog_s = watchdog_s         # None -> disabled
        self._watch: Dict[int, list] = {}    # rid -> [tokens, since]

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def resolve_slo(self, slo) -> SLOClass:
        if isinstance(slo, SLOClass):
            return slo
        if slo in self._slos:
            return self._slos[slo]
        if slo in SLO_CLASSES:
            return SLO_CLASSES[slo]
        raise KeyError(f"unknown SLO class {slo!r}; known: "
                       f"{sorted(self._slos) + sorted(SLO_CLASSES)}")

    def submit(self, prompt=None, slo="offline", *,
               max_new: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               arrival: Optional[float] = None,
               rid: Optional[int] = None) -> ResponseHandle:
        """Admit one request at the current fleet time.

        ``prompt``: token array for LM pools (or a prebuilt
        :class:`LMWork`); None routes a cost-model (vision) request.
        Rejection at admission (no plan fits the SLO at current load) is
        surfaced on the handle, not raised.
        """
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        work = None
        if isinstance(prompt, LMWork):
            work = prompt
        elif prompt is not None:
            work = LMWork(np.asarray(prompt, np.int32), max_new=max_new,
                          sampling=sampling)
        if work is not None and work.prompt.shape[0] == 0:
            # fail fast with an actionable error, mirroring the
            # oversized-max_new check below: a zero-length prompt used
            # to slip into a pool's batch and crash it mid-admission
            # (the -0 slice selects the whole row), taking the already-
            # batched neighbors down with it
            raise ValueError(
                "empty prompt: LM serving needs at least one prompt "
                "token to prefill; submit prompt=None to route a "
                "cost-model (vision) request instead")
        if work is not None and work.max_new is not None and self.engines:
            # fail fast with an actionable error instead of counting the
            # request admitted and crashing inside a pool's batch.  The
            # bound is the SMALLEST engine pool's budget: dispatch is
            # payload-blind, so any LM pool may end up serving this
            # request (routing by max_new is future work)
            budget = min(e.max_len - e.prompt_len
                         for e in self.engines.values())
            if work.max_new > budget:
                raise ValueError(
                    f"max_new={work.max_new} exceeds the smallest LM "
                    f"pool's budget ({budget}), and dispatch does not "
                    f"route by max_new; raise PoolSpec.max_new — it "
                    f"sizes the per-request KV allocation")
        if work is not None and self.engines:
            # same fast-fail for prompts: dispatch is payload-blind, so
            # the (padded) prompt plus requested max_new must fit EVERY
            # LM pool's KV table — each pool's own chunk grid decides
            # the padding, so ask the servers rather than guessing.
            # (max_new=None resolves to the pool default, which sizes
            # max_len by construction and can never overflow.)
            s = int(work.prompt.shape[0])
            mn = max(work.max_new or 1, 1)
            for name, e in self.engines.items():
                pad_fn = getattr(e, "padded_prompt_len", None)
                if pad_fn is None and s > e.prompt_len:   # windowed pool
                    raise ValueError(
                        f"prompt of {s} tokens exceeds pool {name!r}'s "
                        f"windowed prompt_len bucket of {e.prompt_len}; "
                        f"use an engine pool (chunked paged prefill "
                        f"lifts the bucket limit)")
                padded = e.prompt_len if pad_fn is None else pad_fn(s)
                if padded + mn > e.max_len:
                    raise ValueError(
                        f"prompt of {s} tokens ({padded} padded) + "
                        f"max_new={mn} cannot fit pool {name!r}'s "
                        f"context of {e.max_len}; raise "
                        f"PoolSpec.max_prompt_len (chunked paged "
                        f"prefill sizes the KV table, not a compiled "
                        f"shape) or shrink the request")
        rreq = RouterRequest(rid, self.resolve_slo(slo),
                             self.now if arrival is None else arrival,
                             payload=work)
        self.tracer.begin_request(
            rreq.rid, rreq.arrival_s, slo=rreq.slo.name,
            kind="lm" if work is not None else "cost",
            prompt=None if work is None else int(work.prompt.shape[0]),
            max_new=None if work is None else work.max_new)
        # the orbit controller (if attached) gates admission on the
        # global energy bucket: deferrable work parks until sunlight
        # returns; rejection is the dry-battery last resort
        verdict = ("dispatch" if self.controller is None
                   else self.controller.admission(rreq))
        if verdict == "dispatch":
            admitted = self.router.submit(rreq, self.now)
            if (admitted and self.controller is not None
                    and work is not None):
                # charge the expected plan energy at submit time — the
                # bucket sees admitted load before its tokens decode;
                # the controller refunds the estimate when the request
                # settles and the real metered spend has drained
                self.controller.prepay(rreq, work.max_new)
        elif verdict == "defer":
            self.controller.defer(rreq, self.now)
            admitted = True                  # accepted; dispatches later
        else:                                # "reject"
            self.router.telemetry.record_rejection(rreq.slo.name, self.now)
            self.router.telemetry.energy_rejected += 1
            # reason ledger only (admitted=False): the request was never
            # admitted, so the accounting invariant stays intact
            self.router.telemetry.record_drop(rreq.slo.name, "dry_battery",
                                              admitted=False)
            self.tracer.end_request(rreq.rid, self.now, "energy_rejected",
                                    slo=rreq.slo.name)
            admitted = False
        handle = ResponseHandle(self, rreq, work, admitted)
        self._handles[rid] = handle
        return handle

    def _on_token(self, rid: int, tok: int, step: int) -> None:
        h = self._handles.get(rid)
        if h is not None:
            # TTFT stamp: the first token the consumer actually saw,
            # first push wins — honest across reroutes and failovers
            if h._rreq.first_out_s is None:
                h._rreq.first_out_s = self.now
            h._push(tok, step)

    # ------------------------------------------------------------------
    # radiation hardening (data-plane faults + watchdog backstop)
    # ------------------------------------------------------------------
    def _apply_data_plane_fault(self, ev) -> None:
        """Deliver one kv_bitflip / slot_stall / handoff_loss event into
        the target pool's engine (registered as the failover
        controller's ``data_plane`` handler)."""
        f = ev.fault
        eng = self.engines.get(f.pool)
        if eng is None:
            return                 # cost-model pool: nothing to corrupt
        if f.kind == "kv_bitflip" and ev.kind == "degrade":
            eng.arm_bitflip(f.seed)
            self.tracer.event("kv_bitflip", self.now, pool=f.pool,
                              seed=f.seed)
        elif f.kind == "slot_stall":
            if ev.kind == "degrade":
                eng.stall_slot(f.slot)
                self.tracer.event("slot_stall", self.now, pool=f.pool,
                                  slot=f.slot)
            else:                  # transient stall recovers on schedule
                eng.unstall_slot(f.slot)
                self.tracer.event("slot_unstall", self.now, pool=f.pool,
                                  slot=f.slot)
        elif f.kind == "handoff_loss" and ev.kind == "degrade":
            inject = getattr(eng, "inject_handoff_loss", None)
            if inject is not None:   # unified pools have no seam to cut
                inject()
                self.tracer.event("handoff_loss", self.now, pool=f.pool)

    def _watchdog_tick(self) -> None:
        """Fleet-level no-progress backstop: a live admitted handle whose
        token count has not moved for ``watchdog_s`` of virtual time
        counts a watchdog trip (the engine-level watchdog recovers the
        slot; this one makes silent stalls visible even when it cannot)."""
        for rid, h in list(self._watch.items()):
            if rid not in self._handles or self._handles[rid].done:
                self._watch.pop(rid, None)
        for rid, h in self._handles.items():
            if h.done or not h.admitted:
                continue
            n = len(h._tokens)
            rec = self._watch.get(rid)
            if rec is None or rec[0] != n:
                self._watch[rid] = [n, self.now]
            elif self.now - rec[1] > self.watchdog_s:
                self.router.telemetry.watchdog_trips += 1
                self.tracer.event("client_watchdog", self.now, rid=rid,
                                  tokens=n)
                rec[1] = self.now  # re-arm; one trip per stall window

    # ------------------------------------------------------------------
    # clock
    # ------------------------------------------------------------------
    def advance(self, dt: Optional[float] = None) -> None:
        """Move the fleet clock one tick and apply due fault events,
        then run the orbit control loop (bucket, mode, deferral release,
        autoscaling) at the new time."""
        self.now += self.dt if dt is None else dt
        if self.failover is not None:
            self.failover.poll(self.now)
        # SLO burn evaluation runs before the orbit controller so the
        # control loop sees this tick's alert state (a firing page floors
        # the mode at conserve and holds autoscaler scale-down)
        if self.slo_engine is not None:
            self.slo_engine.step(self.now)
        if self.controller is not None:
            self.controller.step(self.now)
        # hardened engines get their budgeted background scrub pass each
        # tick (the decode hot path carries its own fused verify; this
        # covers blocks held while a pool idles between batches).  Scrub
        # findings land outside any executor batch window, so their
        # telemetry deltas are charged here.
        for name, eng in self.engines.items():
            if not getattr(eng, "harden", False):
                continue
            b0 = (eng.bitflips_detected, eng.blocks_quarantined)
            eng.scrub()
            b1 = (eng.bitflips_detected, eng.blocks_quarantined)
            if b1 != b0:
                pc = self.router.telemetry.pools.get(name)
                if pc is not None:
                    pc.bitflips_detected += b1[0] - b0[0]
                    pc.blocks_quarantined += b1[1] - b0[1]
                self.tracer.event("scrub_hit", self.now, pool=name,
                                  found=b1[0] - b0[0])
        if self.watchdog_s is not None:
            self._watchdog_tick()
        self.timeseries.observe(self, self.now)

    def pump(self) -> List[RouterRequest]:
        """Advance every pool at the current time (non-blocking)."""
        completed = self.router.step(self.now)
        if self._retiring:
            self._finish_retirements()
        return completed

    def step(self, dt: Optional[float] = None) -> List[RouterRequest]:
        self.advance(dt)
        return self.pump()

    def drain(self, max_s: float = 600.0,
              dt: Optional[float] = None) -> None:
        """Run until every admitted request and scheduled fault resolves."""
        while self.outstanding or self.pending_faults:
            self.step(dt)
            if self.now > max_s:
                raise RuntimeError(f"fleet failed to drain by t={max_s}s")

    # ------------------------------------------------------------------
    # live fleet mutation (the orbit autoscaler's operations; callers
    # can also drive them directly)
    # ------------------------------------------------------------------
    def attach_controller(self, controller) -> None:
        """Wire an orbit FleetController into the clock and admission
        path (one per client; built by ``OrbitSpec.attach``)."""
        if self.controller is not None:
            raise ValueError("a controller is already attached")
        self.controller = controller

    def attach_slo(self, engine) -> None:
        """Wire an SLO engine into the clock (one per client; built by
        ``SLOSpec.attach``): ``advance`` steps its burn-rate evaluation
        every tick."""
        if self.slo_engine is not None:
            raise ValueError("an SLO engine is already attached")
        self.slo_engine = engine

    def add_pool(self, pool_spec, warm: bool = True) -> None:
        """Grow the fleet live: build the pool a PoolSpec describes and
        join it to the router (frontier refreshes over the widened
        profile set).  Engine pools reuse the model the fleet was built
        with, on the fleet's device."""
        from repro_torch.serving.spec import build_pool
        pool, engine, ex = build_pool(pool_spec, self._layers,
                                      model=self._model, warm=warm,
                                      device=self.device)
        if ex is not None:
            ex.on_token = self._on_token
        self.router.add_pool(pool)
        if ex is not None and ex.prefill_counters is not None:
            # bind back: a reused stage name continues its history
            ex.prefill_counters = self.router.register_stage_pool(
                ex.prefill_pool, ex.prefill_counters)
        if engine is not None:
            self.engines[pool_spec.name] = engine
        self.router.telemetry.pools_added += 1

    def retire_pool(self, name: str) -> None:
        """Shrink the fleet gracefully: the pool stops taking new
        dispatches immediately, finishes everything it holds (no
        in-flight stream is dropped), and is removed once drained — on
        a later ``step()``/``pump()``, not synchronously."""
        from repro_torch.router.pool import PoolState
        pool = self.router.pools[name]       # KeyError -> unknown pool
        live = [p for p in self.router.pools.values()
                if not p.draining and p.state is not PoolState.DEAD]
        if live == [pool]:
            raise ValueError(f"pool {name!r} is the last live pool; a "
                             f"fleet cannot retire itself empty")
        if not pool.draining:
            pool.draining = True
            self._retiring.add(name)

    def set_capacity(self, name: str, capacity: int) -> None:
        """Resize a pool's concurrent-batch capacity in place."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.router.pools[name].capacity = capacity

    def _finish_retirements(self) -> None:
        for name in list(self._retiring):
            pool = self.router.pools.get(name)
            if pool is None:                 # removed out from under us
                self._retiring.discard(name)
                continue
            if pool.load == 0:
                self.router.remove_pool(name)
                self.engines.pop(name, None)
                self._retiring.discard(name)
                self.router.telemetry.pools_retired += 1

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def enable_tracing(self, max_spans: Optional[int] = None) -> None:
        """Turn the flight recorder on: every subsequent submission
        records its span chain (``ResponseHandle.trace()`` reads one
        back; ``repro_torch.obs.export`` serializes them all)."""
        if max_spans is not None:
            self.tracer.max_spans = max_spans
        self.tracer.enabled = True

    @property
    def outstanding(self) -> int:
        deferred = (0 if self.controller is None
                    else self.controller.deferred_count)
        return self.router.outstanding + deferred

    @property
    def pending_faults(self) -> int:
        return 0 if self.failover is None else self.failover.pending_faults

    @property
    def telemetry(self) -> Dict:
        """The fleet-wide snapshot (JSON-serializable)."""
        return self.router.telemetry.snapshot()

    def handle(self, rid: int) -> ResponseHandle:
        return self._handles[rid]
