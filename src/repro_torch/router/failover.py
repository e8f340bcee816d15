"""Online failover: pool degradation -> reschedule -> re-dispatch.

The controller consumes :class:`~repro_torch.runtime.fault.PoolFaultInjector`
events on the router's clock.  On a degrade event it:
  1. marks the pool DEGRADED/DEAD and evicts every queued *and in-flight*
     request whose plan needs a lost profile (an SEU destroys in-flight
     work — those requests restart, they are not resumed);
  2. refreshes the router's Pareto frontier over the surviving profile
     subset (``reschedule_over_subset``) so subsequent admissions never
     see a dead device;
  3. re-dispatches each displaced request — best-effort if its SLO is no
     longer satisfiable, dropped (and counted) only when nothing routable
     survives anywhere.

Recover events restore the profiles and refresh the frontier again, so a
transient SEU only narrows the plan space for its scrub window.
"""
from __future__ import annotations

from typing import List

from repro_torch.runtime.fault import PoolFaultEvent, PoolFaultInjector
from repro_torch.router.dispatch import Router
from repro_torch.router.pool import RouterRequest


class FailoverController:
    def __init__(self, router: Router, injector: PoolFaultInjector):
        self.router = router
        self.injector = injector
        self.events: List[PoolFaultEvent] = []     # applied, for reports
        self.frontier_sizes: List[tuple] = []      # (t, |frontier|) trace
        # data-plane faults (kv_bitflip / slot_stall / handoff_loss) act
        # inside a pool's engine, not on the pool itself; the serving
        # client registers this handler to deliver them — the router
        # layer stays ignorant of engine internals
        self.data_plane = None             # callable(event) or None

    def poll(self, now: float) -> List[RouterRequest]:
        """Apply every fault event due by ``now``; returns the requests
        that were displaced and re-dispatched (for tests/observability)."""
        displaced_total: List[RouterRequest] = []
        for ev in self.injector.poll(now):
            self.events.append(ev)
            if ev.fault.kind != "pool":
                if self.data_plane is not None:
                    self.data_plane(ev)
                continue
            pool = self.router.pools.get(ev.fault.pool)
            if pool is None:
                continue
            if ev.kind == "degrade":
                displaced = pool.degrade(ev.fault.lost_profiles)
                self.router.telemetry.failovers += 1
                self.router.refresh_plans()
                tracer = self.router.telemetry.tracer
                for req in displaced:
                    # the SEU destroyed whatever stage held the request;
                    # close it here (degrade() has no clock) so failover
                    # chains never leak open queue/serve spans
                    tracer.finish(req.rid, "serve", now, evicted=True)
                    tracer.finish(req.rid, "queue", now, evicted=True)
                    tracer.event("failover", now, rid=req.rid,
                                 pool=ev.fault.pool,
                                 lost=list(ev.fault.lost_profiles))
                    self.router.redispatch(req, now)
                displaced_total.extend(displaced)
            elif ev.kind == "recover":
                pool.recover(ev.fault.lost_profiles)
                self.router.refresh_plans()
            self.frontier_sizes.append((now, len(self.router.frontier)))
        return displaced_total

    @property
    def pending_faults(self) -> int:
        return self.injector.pending
