"""Request SLO classes — the contract a dispatch decision must satisfy.

A space-segment serving stack does not have one latency target: a
downlink-critical pose estimate feeding the attitude loop has a hard
deadline and a tight accuracy budget, while background science imagery
can wait seconds but must sip energy.  An :class:`SLOClass` captures the
three axes the Pareto scheduler already prices — latency, energy,
accuracy penalty — as per-request *budgets*, and plan selection becomes
``best_under_accuracy``-style filtering of the live frontier.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.scheduler import ScheduledPlan


@dataclass(frozen=True)
class SLOClass:
    name: str
    max_latency_s: float                 # end-to-end deadline per request
    max_energy_j: float = math.inf       # per-inference energy budget
    max_accuracy_penalty: float = math.inf  # tolerated error-budget units
    priority: int = 0                    # higher preempts at equal deadline

    def admits(self, plan: ScheduledPlan) -> bool:
        """Does this plan's *nominal* cost fit the budgets?  (Queueing and
        batching can still push a served request over — that is recorded
        as a violation, not prevented at admission.)"""
        return (plan.latency_s <= self.max_latency_s
                and plan.energy_j <= self.max_energy_j
                and plan.accuracy_penalty <= self.max_accuracy_penalty)


# The demo/benchmark traffic mix.  Budgets are sized for the paper's
# UrsoNet-on-board operating points (DPU ~53 ms, VPU ~246 ms, Table I).
DOWNLINK_CRITICAL = SLOClass("downlink-critical", max_latency_s=0.12,
                             max_accuracy_penalty=0.10, priority=2)
REALTIME_TRACKING = SLOClass("realtime-tracking", max_latency_s=0.40,
                             max_energy_j=5.0, max_accuracy_penalty=0.30,
                             priority=1)
BACKGROUND_SCIENCE = SLOClass("background-science", max_latency_s=3.0,
                              max_energy_j=1.5, max_accuracy_penalty=0.60)
BULK_REPROCESS = SLOClass("bulk-reprocess", max_latency_s=15.0,
                          max_energy_j=1.0)

SLO_CLASSES: Dict[str, SLOClass] = {
    s.name: s for s in (DOWNLINK_CRITICAL, REALTIME_TRACKING,
                        BACKGROUND_SCIENCE, BULK_REPROCESS)
}


def admissible_plans(plans: Sequence[ScheduledPlan],
                     slo: SLOClass) -> List[ScheduledPlan]:
    return [p for p in plans if slo.admits(p)]


def select_plan(plans: Sequence[ScheduledPlan], slo: SLOClass,
                latency_headroom: float = 1.0) -> Optional[ScheduledPlan]:
    """Cheapest admissible plan at *nominal* (load-free) cost: minimize
    energy (the scarce resource on orbit), tie-break on latency then
    accuracy.  ``None`` = infeasible — nothing meets the budgets even on
    an idle fleet.  ``Router._choose`` applies this same policy but with
    a queue-wait completion estimate in place of nominal latency; this
    load-free form is the reference policy (and what capacity planning /
    tests use).

    ``latency_headroom`` < 1 prefers plans whose latency fits in that
    fraction of the budget, leaving slack for batching and queueing; a
    plan that only fits the full budget is still admissible (better to
    serve tight than reject), it just loses the preference.
    """
    ok = admissible_plans(plans, slo)
    if not ok:
        return None
    slack = [p for p in ok
             if p.latency_s <= latency_headroom * slo.max_latency_s]
    return min(slack or ok, key=lambda p: (p.energy_j, p.latency_s,
                                           p.accuracy_penalty))
