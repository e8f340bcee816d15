"""Heterogeneous fleet router: SLO-aware dispatch with online failover
(the port's copy of ``repro.router``; plain Python, no framework code).

MPAI's offline result is a speed/accuracy/energy Pareto frontier over a
pool of diverse accelerators (INT8 DPU, FP16 VPU, Edge TPU, CPU).  This
package is the *online* half: a serving fabric that routes live traffic
across those pools and keeps serving through transient device faults —
the operating regime of an onboard vision system in space.

Architecture (one module per concern)::

      requests ──> Router.submit ──────────────────────────────┐
                     │  admission: SLO budgets vs live frontier │ slo.py
                     │  plan pick: cheapest admissible          │
                     │  placement: least-loaded compatible pool │ dispatch.py
                     v                                          │
      ┌─ AcceleratorPool ─┐  ┌─ AcceleratorPool ─┐  ...         │ pool.py
      │ {dpu, vpu}        │  │ {edge_tpu, cpu}   │              │
      │ per-plan queues   │  │ bounded batching  │              │
      │ CostModel/Server  │  │ windows, capacity │              │
      └────────┬──────────┘  └─────────┬─────────┘              │
               v                       v                        │
             completions -> Telemetry (latency/energy/violations) telemetry.py

      PoolFaultInjector (runtime/fault.py) ──> FailoverController  failover.py
        degrade: evict affected requests, reschedule the frontier
        over the surviving profiles, re-dispatch; recover: restore.

Key design points:

* **Pools own profile sets, not single devices.**  A plan is routable to
  a pool iff every profile its segments use survives there — segment
  handoff is a board-level link, so a plan cannot straddle pools.
* **Admission rejects, failover never does.**  An infeasible SLO fails
  fast at submit; a request displaced by a fault is re-dispatched
  best-effort and any deadline miss is *reported* (telemetry violation),
  never silently dropped — matching the paper's companion requirement
  that onboard serving degrades gracefully under SEUs.
* **All plans come from the scheduler.**  Dispatch only ever selects
  from ``schedule()`` / ``reschedule_over_subset()`` output, so every
  routed plan is Pareto-optimal over the currently-live profile subset.

This package is the routing *fabric*; the public serving surface is
``repro_torch.serving`` (FleetSpec -> ServingClient), which assembles routers,
pools, and engine-backed executors from declarative specs — call sites
should not construct :class:`Router` directly.
"""
from repro_torch.router.dispatch import RetryPolicy, Router
from repro_torch.router.failover import FailoverController
from repro_torch.router.pool import (AcceleratorPool, CostModelExecutor,
                               PoolState, RouterRequest)
from repro_torch.router.slo import (SLO_CLASSES, SLOClass, admissible_plans,
                              select_plan)
from repro_torch.router.telemetry import Telemetry

__all__ = [
    "AcceleratorPool", "CostModelExecutor", "FailoverController",
    "PoolState", "RetryPolicy", "Router", "RouterRequest", "SLOClass",
    "SLO_CLASSES",
    "Telemetry", "admissible_plans", "select_plan",
]
