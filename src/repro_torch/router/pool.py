"""Accelerator pool: a group of co-located devices executing routed batches.

A pool owns a *set of accelerator profiles* (e.g. one ZCU104 board is
``{mpsoc_dpu, myriadx_vpu}``) and can host any :class:`ScheduledPlan`
whose segment assignments use only profiles it still has.  Requests queue
per-plan; a bounded batching window groups them (a request waits at most
``max_wait_s`` before its group launches even partially full); up to
``capacity`` batches execute concurrently.

Execution is pluggable:
  * :class:`CostModelExecutor` prices the batch with the roofline cost
    model at its actual size — the pool advances on the router's virtual
    clock.  This is what the failover demo / benchmark use: the routing
    fabric is exercised end-to-end without real boards.
  * :class:`~repro_torch.serving.executor.EngineExecutor` (the serving
    facade) drives a real LM server — the continuous-batching engine or
    the windowed baseline — via the shared non-blocking ``step()`` API
    and reports measured wall latency plus decode telemetry (decode-only
    tokens/s, slot occupancy, OutOfBlocks deferrals).

Health is tri-state: HEALTHY, DEGRADED (lost a strict subset of its
profiles — SEU took a device out), DEAD (nothing survives).  Degrading
evicts every queued and in-flight request whose plan needs a lost
profile; the FailoverController re-dispatches them.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import LayerCost
from repro_torch.core.scheduler import (ScheduledPlan, plan_profiles,
                                  price_assignments)
from repro_torch.router.slo import SLOClass
from repro_torch.router.telemetry import PoolCounters


@dataclass
class RouterRequest:
    """One admitted unit of traffic flowing through the router."""
    rid: int
    slo: SLOClass
    arrival_s: float
    payload: Any = None                  # e.g. token prompt for an LM pool
    plan: Optional[ScheduledPlan] = None
    pool: Optional[str] = None
    enqueue_s: float = 0.0
    done_s: Optional[float] = None
    violated: bool = False
    dropped: bool = False
    rerouted: int = 0                    # failover re-dispatch count
    deferred: bool = False               # parked by the orbit energy cap
    # golden-signal SLI stamps (virtual clock; None until observed)
    serve_s: Optional[float] = None      # first batch launch (first wins)
    first_out_s: Optional[float] = None  # first token reached the consumer
    queue_wait_s: Optional[float] = None # total time queued, all launches

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo.max_latency_s


class PoolState(Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    DEAD = "dead"


class CostModelExecutor:
    """Price a batch with the roofline model at its actual size."""

    def __init__(self, layers: Sequence[LayerCost]):
        self.layers = list(layers)

    def run(self, plan: ScheduledPlan, requests: Sequence[RouterRequest],
            now: float = 0.0) -> Tuple[float, float]:
        return price_assignments(self.layers, plan, batch=len(requests))


@dataclass
class _InFlightBatch:
    plan: ScheduledPlan
    requests: List[RouterRequest]
    start_s: float
    finish_s: float
    energy_j: float


class AcceleratorPool:
    def __init__(self, name: str, profiles: Iterable[str], executor,
                 capacity: int = 1, max_window: int = 4,
                 max_wait_s: float = 0.02, urgent_priority: int = 2,
                 counters: Optional[PoolCounters] = None,
                 shards: int = 1):
        self.name = name
        self.profiles: Tuple[str, ...] = tuple(profiles)
        self.executor = executor
        self.capacity = capacity
        self.max_window = max_window
        self.max_wait_s = max_wait_s
        self.urgent_priority = urgent_priority
        # decode fan-out width behind this pool's seam (CoProcServer
        # shards): the router's completion estimate scales concurrent
        # batch waves by it, so a sharded pool absorbs load N-wide
        self.shards = shards
        self.state = PoolState.HEALTHY
        self.draining = False            # graceful retirement: no new work
        self.counters = counters if counters is not None else PoolCounters()
        self.tracer = None               # Router wires the shared Tracer
        self._lost: Counter = Counter()        # profile -> overlapping faults
        self._queues: Dict[ScheduledPlan, List[RouterRequest]] = {}
        self._inflight: List[_InFlightBatch] = []

    # ------------------------------------------------------------------
    # capability / load
    # ------------------------------------------------------------------
    @property
    def effective_profiles(self) -> frozenset:
        return frozenset(p for p in self.profiles if not self._lost[p])

    def hosts(self, plan: ScheduledPlan) -> bool:
        """Do this pool's surviving profiles cover ``plan``?  The pure
        capability check — what decides whether *already-held* work can
        keep running here (``degrade`` eviction)."""
        return (self.state is not PoolState.DEAD
                and plan_profiles(plan) <= self.effective_profiles)

    def compatible(self, plan: ScheduledPlan) -> bool:
        """Can this pool take NEW work for ``plan``?  A draining pool
        (graceful retirement) refuses new dispatches but keeps executing
        what it already holds — so this is ``hosts`` minus draining."""
        return not self.draining and self.hosts(plan)

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def in_flight(self) -> int:
        return sum(len(b.requests) for b in self._inflight)

    @property
    def load(self) -> int:
        """Least-loaded routing key: total requests not yet completed."""
        return self.queue_depth + self.in_flight

    # ------------------------------------------------------------------
    # dispatch side
    # ------------------------------------------------------------------
    def enqueue(self, req: RouterRequest, now: float) -> None:
        assert self.compatible(req.plan), (
            f"pool {self.name} cannot host plan {req.plan.assignments}")
        req.pool = self.name
        req.enqueue_s = now
        self._queues.setdefault(req.plan, []).append(req)
        if self.tracer is not None:
            self.tracer.begin(req.rid, "queue", now, pool=self.name,
                              rerouted=req.rerouted)
        self.counters.dispatched += 1
        self.counters.queue_depth_now = self.queue_depth
        self.counters.load_now = self.load

    def step(self, now: float) -> List[RouterRequest]:
        """Complete due batches, then launch ready windows.  Non-blocking:
        returns the requests completed at this instant (their ``done_s``
        is the batch finish time, not ``now``)."""
        completed: List[RouterRequest] = []
        still = []
        for b in self._inflight:
            if b.finish_s <= now:
                for r in b.requests:
                    r.done_s = b.finish_s
                    completed.append(r)
                    if self.tracer is not None:
                        self.tracer.finish(r.rid, "serve", b.finish_s)
                self.counters.completed += len(b.requests)
            else:
                still.append(b)
        self._inflight = still
        while len(self._inflight) < self.capacity:
            launched = self._launch_ready(now)
            if not launched:
                break
        self.counters.queue_depth.record(self.queue_depth)
        self.counters.queue_depth_now = self.queue_depth
        self.counters.load_now = self.load
        return completed

    def _launch_ready(self, now: float) -> bool:
        ready = None
        for plan, q in self._queues.items():
            if not q:
                continue
            full = len(q) >= self.max_window
            waited = now - q[0].enqueue_s >= self.max_wait_s
            # deadline-tight traffic skips the fill wait: a smaller batch
            # beats a deeper one when the budget is the bottleneck
            urgent = any(r.slo.priority >= self.urgent_priority for r in q)
            if full or waited or urgent:
                # oldest head request first (FIFO across plan groups)
                if ready is None or q[0].enqueue_s < ready[1][0].enqueue_s:
                    ready = (plan, q)
        if ready is None:
            return False
        plan, q = ready
        batch, self._queues[plan] = q[:self.max_window], q[self.max_window:]
        for r in batch:                  # SLI stamps: first launch wins
            if r.serve_s is None:        # for serve_s; queue wait adds up
                r.serve_s = now          # across reroute re-queues
            r.queue_wait_s = (r.queue_wait_s or 0.0) + (now - r.enqueue_s)
        if self.tracer is not None:
            for r in batch:              # queue ends where serve begins
                self.tracer.finish(r.rid, "queue", now)
        lat, energy = self.executor.run(plan, batch, now)
        if self.tracer is not None:
            bid = self.counters.batches
            share = energy / len(batch)  # assigned at launch: eviction
            for r in batch:              # cannot un-spend batch energy
                self.tracer.begin(r.rid, "serve", now, pool=self.name,
                                  bid=f"{self.name}:{bid}",
                                  batch=len(batch), lat_s=lat,
                                  energy_j=share)
        self._inflight.append(_InFlightBatch(plan, batch, now, now + lat,
                                             energy))
        self.counters.batches += 1
        self.counters.batch_size.record(len(batch))
        self.counters.busy_s += lat
        self.counters.energy_j += energy
        return True

    # ------------------------------------------------------------------
    # fault side
    # ------------------------------------------------------------------
    def degrade(self, lost_profiles: Iterable[str]) -> List[RouterRequest]:
        """SEU hit: drop ``lost_profiles`` (all of them when empty) and
        evict every request whose plan can no longer run here.  In-flight
        work on a lost device is destroyed, so those batches evict too."""
        lost = tuple(lost_profiles) or self.profiles
        self._lost.update(lost)
        self.state = (PoolState.DEAD if not self.effective_profiles
                      else PoolState.DEGRADED)
        displaced: List[RouterRequest] = []
        for plan in list(self._queues):
            if not self.hosts(plan):     # NOT compatible(): a draining
                displaced.extend(self._queues.pop(plan))  # pool keeps the
        still = []                       # work the fault didn't touch
        for b in self._inflight:
            if self.hosts(b.plan):
                still.append(b)
            else:
                displaced.extend(b.requests)
        self._inflight = still
        for r in displaced:
            r.pool = None
        self.counters.evicted += len(displaced)
        self.counters.queue_depth_now = self.queue_depth
        self.counters.load_now = self.load
        return displaced

    def recover(self, restored_profiles: Iterable[str]) -> None:
        restored = tuple(restored_profiles) or self.profiles
        self._lost.subtract(restored)
        self._lost += Counter()                # drop zero/negative entries
        self.state = (PoolState.HEALTHY if not +self._lost
                      else PoolState.DEGRADED)
