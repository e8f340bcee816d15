"""Admission control + SLO-aware dispatch over heterogeneous pools.

Per request the router:
  1. filters the *live* Pareto frontier (recomputed whenever the set of
     healthy profiles changes) down to plans whose nominal cost fits the
     request's SLO budgets AND that at least one live pool can host;
  2. estimates end-to-end completion per candidate (plan, pool) — nominal
     plan latency plus a queue-wait term from the pool's current load —
     and rejects the request at admission when no estimate fits the
     deadline: infeasible budgets AND hopeless overload fail fast instead
     of rotting in a queue;
  3. otherwise picks the cheapest surviving plan (min energy, preferring
     candidates with latency slack) and routes it to the least-loaded
     compatible pool, where it batches inside a bounded window.

The queue-wait term is what keeps a cheap plan from becoming a magnet: a
frontier plan that funnels to one congested pool loses to a slightly
dearer plan on an idle pool as soon as the wait estimate breaks its SLO.

The router never invents plans: everything it dispatches comes from
``core.scheduler.schedule`` / ``reschedule_over_subset``, so a dispatched
plan is Pareto-optimal over the surviving profile set by construction —
a property the test suite checks directly.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cost_model import LayerCost
from repro_torch.core.scheduler import ScheduledPlan, reschedule_over_subset
from repro_torch.router.pool import AcceleratorPool, PoolState, RouterRequest
from repro_torch.router.slo import SLOClass
from repro_torch.router.telemetry import Telemetry

_EPS = 1e-9


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded failover redispatch, per SLO class.

    The first redispatch after an eviction is immediate (a healthy
    fleet should re-place displaced work the same tick); every further
    attempt waits ``backoff_s * multiplier**(attempt-2)`` on the virtual
    clock, capped at ``max_backoff_s``, so a flapping pool cannot spin
    the router hot.  Past ``max_attempts`` the request drops with the
    ``retry_exhausted`` reason code instead of retrying forever.
    ``give_up_past_deadline`` optionally drops a queued retry whose
    deadline already passed (``deadline`` reason) rather than serving it
    best-effort."""
    max_attempts: int = 5
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    give_up_past_deadline: bool = False

    def delay_s(self, attempt: int) -> float:
        """Backoff before redispatch ``attempt`` (2nd and later)."""
        return min(self.backoff_s * self.multiplier ** max(attempt - 2, 0),
                   self.max_backoff_s)


class Router:
    def __init__(self, layers: Sequence[LayerCost],
                 pools: Sequence[AcceleratorPool],
                 batch: int = 1, max_segments: int = 2,
                 accuracy_penalty: Optional[Dict[str, float]] = None,
                 cut_candidates: Optional[Sequence[int]] = None,
                 latency_headroom: float = 0.6,
                 telemetry: Optional[Telemetry] = None):
        if not pools:
            raise ValueError("router needs at least one pool")
        self.layers = list(layers)
        self.latency_headroom = latency_headroom
        # "nominal" | "conserve" — set by the orbit FleetController when
        # the global energy bucket runs low; flips plan selection from
        # latency-slack-first to energy-first (see _choose)
        self.energy_mode = "nominal"
        self.pools: Dict[str, AcceleratorPool] = {p.name: p for p in pools}
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        for p in pools:                    # pool counters live in telemetry
            self.telemetry.pools[p.name] = p.counters
            p.tracer = self.telemetry.tracer
            p.executor.tracer = self.telemetry.tracer
            p.executor.pool_name = p.name
        self._sched_kw = dict(batch=batch, max_segments=max_segments,
                              accuracy_penalty=accuracy_penalty,
                              cut_candidates=cut_candidates)
        # bounded failover retries: per-SLO-class overrides on top of one
        # default policy; queued (backed-off) retries wait on this heap
        # and drain in step(now)
        self.default_retry = RetryPolicy()
        self.retry_policies: Dict[str, RetryPolicy] = {}
        self._retries: List[Tuple[float, int, RouterRequest]] = []
        self._retry_seq = 0
        self.all_profiles = sorted({prof for p in pools
                                    for prof in p.profiles})
        self.frontier: List[ScheduledPlan] = []
        self.refresh_plans(count=False)

    # ------------------------------------------------------------------
    # plan management
    # ------------------------------------------------------------------
    def available_profiles(self) -> Set[str]:
        out: Set[str] = set()
        for p in self.pools.values():
            if p.state is not PoolState.DEAD:
                out |= p.effective_profiles
        return out

    def refresh_plans(self, count: bool = True) -> None:
        """Recompute the frontier over the surviving profile subset."""
        avail = self.available_profiles()
        lost = [p for p in self.all_profiles if p not in avail]
        self.frontier = reschedule_over_subset(
            self.layers, self.all_profiles, lost=lost, **self._sched_kw)
        if count:
            self.telemetry.reschedules += 1

    # ------------------------------------------------------------------
    # live fleet mutation (the orbit autoscaler's seam)
    # ------------------------------------------------------------------
    def add_pool(self, pool: AcceleratorPool) -> None:
        """Join a pool to the live fleet and refresh the frontier over the
        widened profile set.  Names must be fresh — a name that collides
        with a live pool is an error, and reusing a *retired* name would
        splice two pools' telemetry histories (the autoscaler's monotonic
        clone suffixes guarantee freshness)."""
        if pool.name in self.pools:
            raise ValueError(f"pool {pool.name!r} is already routed")
        self.pools[pool.name] = pool
        self.telemetry.pools[pool.name] = pool.counters
        pool.tracer = self.telemetry.tracer
        pool.executor.tracer = self.telemetry.tracer
        pool.executor.pool_name = pool.name
        merged = sorted(set(self.all_profiles) | set(pool.profiles))
        self.all_profiles = merged
        self.refresh_plans()

    def register_stage_pool(self, name: str, counters):
        """Attach telemetry counters for a co-processing *stage* pool —
        e.g. the prefill-class engine feeding a disaggregated decode
        pool.  Stage pools never take independent dispatches (the owning
        executor charges their share of each routed batch — tokens,
        busy time, energy — directly into these counters), but they
        appear in the fleet snapshot like any routed pool, so the orbit
        energy bucket drains against per-stage spend and monitors see
        the DPU/VPU split.

        Returns the counters object actually registered: re-adding a
        stage name whose pool retired earlier *continues* the retired
        counters (callers must charge the returned object), because the
        fleet's cumulative ``energy_j`` must stay monotone for the
        orbit bucket — the same history-splicing ``remove_pool`` keeps
        for routed pools."""
        if name in self.pools:
            raise ValueError(f"pool name {name!r} is already routed")
        if name in self.telemetry.pools:
            return self.telemetry.pools[name]
        self.telemetry.pools[name] = counters
        return counters

    def remove_pool(self, name: str) -> AcceleratorPool:
        """Detach a drained pool (graceful retirement's final step).  The
        pool must be empty — callers mark it ``draining`` and wait for its
        load to reach zero, so no queued or in-flight request is ever
        dropped.  Its counters stay in telemetry as history (and keep the
        fleet's cumulative ``energy_j`` monotone for the energy bucket)."""
        pool = self.pools.get(name)
        if pool is None:
            raise KeyError(f"no pool named {name!r}")
        if pool.load:
            raise ValueError(f"pool {name!r} still holds {pool.load} "
                             f"requests; drain before removing")
        if len(self.pools) == 1:
            raise ValueError("cannot remove the last pool in the fleet")
        del self.pools[name]
        self.refresh_plans()
        return pool

    def routable_plans(self) -> List[ScheduledPlan]:
        """Frontier plans some live pool can actually host.  (A frontier
        plan can be unroutable when its profiles survive only split
        across pools — segments hand off over a board-level link, not the
        network.)"""
        pools = self.pools.values()
        return [pl for pl in self.frontier
                if any(p.compatible(pl) for p in pools)]

    # ------------------------------------------------------------------
    # admission + dispatch
    # ------------------------------------------------------------------
    def _estimate_completion(self, plan: ScheduledPlan,
                             pool: AcceleratorPool) -> float:
        """Rough end-to-end estimate: the pool's backlog forms
        ceil(load+1 / window) batches draining over ``capacity`` slots
        (times the decode fan-out width for sharded pools — N importers
        absorb N batches per wave), each taking about one nominal plan
        latency."""
        batches = math.ceil((pool.load + 1) / pool.max_window)
        waves = math.ceil(batches / (pool.capacity
                                     * getattr(pool, "shards", 1)))
        return waves * plan.latency_s

    def _best_pool(self, plan: ScheduledPlan
                   ) -> Optional[Tuple[AcceleratorPool, float]]:
        """Compatible pool with the best completion estimate (capacity and
        window differ across pools, so least-loaded is not least-wait)."""
        cands = [(self._estimate_completion(plan, p), p.load, p.name, p)
                 for p in self.pools.values() if p.compatible(plan)]
        if not cands:
            return None
        est, _, _, pool = min(cands, key=lambda c: c[:3])
        return pool, est

    def _choose(self, slo: SLOClass
                ) -> Optional[Tuple[ScheduledPlan, AcceleratorPool]]:
        """Best (plan, pool): cheapest energy whose completion estimate
        fits the deadline, preferring candidates with latency slack.  In
        ``energy_mode == "conserve"`` (orbit bucket running low) the
        preference order inverts: joules dominate outright, and a slower
        in-budget plan beats a faster dearer one — the fleet trades
        latency slack for battery."""
        best = best_key = None
        conserve = self.energy_mode == "conserve"
        for plan in self.frontier:
            if not slo.admits(plan):
                continue
            placed = self._best_pool(plan)
            if placed is None:
                continue
            pool, est = placed
            if est > slo.max_latency_s:
                continue
            slack = est <= self.latency_headroom * slo.max_latency_s
            key = ((plan.energy_j, not slack, est, plan.accuracy_penalty)
                   if conserve
                   else (not slack, plan.energy_j, est,
                         plan.accuracy_penalty))
            if best_key is None or key < best_key:
                best_key, best = key, (plan, pool)
        return best

    def submit(self, req: RouterRequest, now: float) -> bool:
        """Admit and dispatch, or reject (returns False) when no routable
        plan can meet the request's SLO budgets at current load."""
        choice = self._choose(req.slo)
        if choice is None:
            self.telemetry.record_rejection(req.slo.name, now)
            self.telemetry.tracer.end_request(req.rid, now, "rejected",
                                              slo=req.slo.name)
            return False
        self._dispatch(req, *choice, now)
        self.telemetry.admitted += 1
        return True

    def retry_policy_for(self, slo_name: str) -> RetryPolicy:
        return self.retry_policies.get(slo_name, self.default_retry)

    def redispatch(self, req: RouterRequest, now: float) -> None:
        """Failover path, under the request's class
        :class:`RetryPolicy`: the first redispatch is immediate, later
        ones wait out an exponential backoff on the virtual clock, and
        the attempt budget is hard — a request that keeps getting
        displaced drops with ``retry_exhausted`` instead of looping."""
        req.rerouted += 1
        policy = self.retry_policy_for(req.slo.name)
        if req.rerouted > policy.max_attempts:
            self._drop(req, now, "retry_exhausted")
            return
        self.telemetry.retries += 1
        self.telemetry.slis.observe_retry(now, req.slo.name, req.pool)
        if req.rerouted == 1:
            self._redispatch_now(req, now)
            return
        heapq.heappush(self._retries,
                       (now + policy.delay_s(req.rerouted),
                        self._retry_seq, req))
        self._retry_seq += 1

    def _redispatch_now(self, req: RouterRequest, now: float) -> None:
        """One redispatch attempt: the request is already admitted, so it
        is never re-rejected — if no surviving plan fits its SLO we still
        serve it best-effort (fastest surviving estimate) and let
        completion record the violation.  Only a total loss (nothing
        routable) drops it."""
        choice = self._choose(req.slo)
        if choice is None:
            cands = []
            for plan in self.routable_plans():
                pool, est = self._best_pool(plan)
                cands.append((est, plan.energy_j, plan, pool))
            if cands:
                est, _, plan, pool = min(cands, key=lambda c: c[:2])
                choice = (plan, pool)
        if choice is None:
            self._drop(req, now, "no_route")
            return
        self._dispatch(req, *choice, now)

    def _drop(self, req: RouterRequest, now: float, reason: str) -> None:
        req.dropped = True
        req.violated = True
        self.telemetry.record_drop(req.slo.name, reason, t=now,
                                   pool=req.pool)
        self.telemetry.tracer.end_request(req.rid, now, "dropped",
                                          rerouted=req.rerouted,
                                          reason=reason)

    def _dispatch(self, req: RouterRequest, plan: ScheduledPlan,
                  pool: AcceleratorPool, now: float) -> None:
        req.plan = plan
        pool.enqueue(req, now)

    # ------------------------------------------------------------------
    # progress
    # ------------------------------------------------------------------
    def step(self, now: float) -> List[RouterRequest]:
        """Advance every pool one tick; record completions + violations."""
        while self._retries and self._retries[0][0] <= now:
            _, _, req = heapq.heappop(self._retries)
            policy = self.retry_policy_for(req.slo.name)
            if policy.give_up_past_deadline and now > req.deadline_s + _EPS:
                self._drop(req, now, "deadline")
                continue
            self._redispatch_now(req, now)
        completed: List[RouterRequest] = []
        for pool in self.pools.values():
            completed.extend(pool.step(now))
        tracer = self.telemetry.tracer
        for r in completed:
            r.violated = r.done_s > r.deadline_s + _EPS
            if r.first_out_s is None:
                # hook-less (cost-model) pools deliver everything at
                # completion, so TTFT degenerates to the e2e latency
                r.first_out_s = r.done_s
            out = getattr(r.payload, "output", None)
            n_out = 0 if out is None else len(out)
            itl = ((r.done_s - r.first_out_s) / (n_out - 1)
                   if n_out > 1 else None)
            self.telemetry.record_completion(r.slo.name,
                                             r.done_s - r.arrival_s,
                                             r.violated, t=r.done_s,
                                             pool=r.pool,
                                             ttft_s=(r.first_out_s
                                                     - r.arrival_s),
                                             itl_s=itl,
                                             queue_wait_s=r.queue_wait_s)
            tracer.end_request(r.rid, r.done_s, "completed",
                               violated=r.violated, pool=r.pool)
        return completed

    @property
    def outstanding(self) -> int:
        # backed-off retries are still live, owed work
        return sum(p.load for p in self.pools.values()) + len(self._retries)
