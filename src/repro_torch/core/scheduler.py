"""MPAI scheduler: partition-point and accelerator-assignment search (the
port's copy of ``repro.core.scheduler``).

The paper demonstrates one hand-chosen partition (conv backbone on the
DPU, FC head on the VPU) and names the general methodology future work.
This module implements that methodology: enumerate candidate partitions of
a layer-cost table across an accelerator pool, price each with the
roofline cost model, attach an accuracy penalty (measured, or the
precision prior), and return the speed-accuracy-energy Pareto frontier.

Invariants (property-tested):
  * every returned plan covers all layers contiguously;
  * no returned plan is Pareto-dominated by another returned plan;
  * the paper's configuration (INT8 backbone + FP16 head) lies on the
    frontier for UrsoNet-like workloads.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.accelerators import PRECISION_ERROR_PRIOR, get_profile
from repro_torch.core.cost_model import LayerCost, SegmentCost, segment_cost
from repro_torch.core.partition import PartitionPlan, Segment
from repro_torch.core.precision import Precision, PrecisionPolicy


@dataclass(frozen=True)
class ScheduledPlan:
    assignments: Tuple[Tuple[int, int, str], ...]   # (start, end, profile)
    latency_s: float
    energy_j: float
    accuracy_penalty: float
    segment_costs: Tuple[SegmentCost, ...] = field(default=(), compare=False)

    def dominates(self, other: "ScheduledPlan") -> bool:
        le = (self.latency_s <= other.latency_s
              and self.energy_j <= other.energy_j
              and self.accuracy_penalty <= other.accuracy_penalty)
        lt = (self.latency_s < other.latency_s
              or self.energy_j < other.energy_j
              or self.accuracy_penalty < other.accuracy_penalty)
        return le and lt

    def to_partition_plan(self, qat: bool = False) -> PartitionPlan:
        segs = []
        for i, (s, e, prof) in enumerate(self.assignments):
            prec = get_profile(prof).precision
            if prec is Precision.INT8:
                pol = (PrecisionPolicy.int8_qat() if qat
                       else PrecisionPolicy.int8())
            elif prec is Precision.FP32:
                pol = PrecisionPolicy.fp32()
            else:
                pol = PrecisionPolicy.bf16()
            segs.append(Segment(f"seg{i}_{prof}", s, e, pol, prof))
        return PartitionPlan(tuple(segs))


def _plan_cost(layers: Sequence[LayerCost], cuts: Sequence[int],
               profiles: Sequence[str], batch: int,
               accuracy_penalty: Dict[str, float]) -> ScheduledPlan:
    bounds = [0, *cuts, len(layers)]
    seg_costs, assignments = [], []
    lat = energy = acc = 0.0
    for i, prof_name in enumerate(profiles):
        prof = get_profile(prof_name)
        lo, hi = bounds[i], bounds[i + 1]
        entry = layers[lo].act_in_elems if i > 0 else 0.0   # handoff at cut
        c = segment_cost(layers[lo:hi], prof, batch, entry_act_elems=entry)
        seg_costs.append(c)
        assignments.append((lo, hi, prof_name))
        lat += c.latency_s
        energy += c.energy_j
        share = sum(l.macs for l in layers[lo:hi]) / max(
            sum(l.macs for l in layers), 1.0)
        acc += accuracy_penalty.get(
            prof_name, PRECISION_ERROR_PRIOR[prof.precision]) * share
    return ScheduledPlan(tuple(assignments), lat, energy, acc, tuple(seg_costs))


def pareto_frontier(plans: Sequence[ScheduledPlan]) -> List[ScheduledPlan]:
    """Sort-based skyline sweep, O(n log n) amortized (was O(n²) pairwise).

    Plans are visited in (latency, energy, accuracy) order, so any
    potential dominator of plan p precedes p.  A staircase over
    (energy, accuracy) — energies strictly increasing, accuracies strictly
    decreasing — summarizes all kept plans: p is dominated iff some kept
    plan has energy <= p.energy and accuracy <= p.accuracy (its latency is
    <= p's by visit order, and exact objective ties are deduped first, so
    at least one inequality is strict).
    """
    order = sorted(plans, key=lambda p: (p.latency_s, p.energy_j,
                                         p.accuracy_penalty))
    seen, cand = set(), []
    for p in order:
        key = (round(p.latency_s, 12), round(p.energy_j, 12),
               round(p.accuracy_penalty, 12))
        if key not in seen:
            seen.add(key)
            cand.append(p)
    es: List[float] = []      # staircase energies, strictly increasing
    accs: List[float] = []    # staircase accuracies, strictly decreasing
    out: List[ScheduledPlan] = []
    for p in cand:
        e, a = p.energy_j, p.accuracy_penalty
        i = bisect.bisect_right(es, e)
        if i and accs[i - 1] <= a:
            continue                          # dominated by an earlier plan
        out.append(p)
        if i and es[i - 1] == e:              # tighter accuracy at same energy
            i -= 1
            del es[i], accs[i]
        j = i                                 # drop steps p now supersedes
        while j < len(es) and accs[j] >= a:
            j += 1
        del es[i:j], accs[i:j]
        es.insert(i, e)
        accs.insert(i, a)
    return out


def schedule(layers: Sequence[LayerCost],
             profile_names: Sequence[str],
             batch: int = 1,
             max_segments: int = 2,
             accuracy_penalty: Optional[Dict[str, float]] = None,
             cut_candidates: Optional[Sequence[int]] = None
             ) -> List[ScheduledPlan]:
    """Enumerate 1- and 2-segment plans (the paper's design space) and
    return the Pareto frontier.  ``accuracy_penalty`` maps profile name ->
    measured penalty (overrides the precision prior — e.g. a QAT-trained
    int8 backbone measures near zero)."""
    accuracy_penalty = accuracy_penalty or {}
    n = len(layers)
    cuts = list(cut_candidates) if cut_candidates else list(range(1, n))
    plans: List[ScheduledPlan] = []
    for p0 in profile_names:
        plans.append(_plan_cost(layers, [], [p0], batch, accuracy_penalty))
    if max_segments >= 2:
        for cut in cuts:
            for p0 in profile_names:
                for p1 in profile_names:
                    if p0 == p1:
                        continue
                    plans.append(_plan_cost(layers, [cut], [p0, p1], batch,
                                            accuracy_penalty))
    return pareto_frontier(plans)


def best_under_accuracy(plans: Sequence[ScheduledPlan],
                        max_penalty: float) -> Optional[ScheduledPlan]:
    ok = [p for p in plans if p.accuracy_penalty <= max_penalty]
    return min(ok, key=lambda p: p.latency_s) if ok else None


def plan_profiles(plan: ScheduledPlan) -> frozenset:
    """Accelerator profiles a plan needs — a pool can host the plan iff it
    still has every one of them."""
    return frozenset(prof for _, _, prof in plan.assignments)


def price_assignments(layers: Sequence[LayerCost],
                      plan: ScheduledPlan, batch: int
                      ) -> Tuple[float, float]:
    """Re-price a plan's segment assignments at an actual batch size.

    ``schedule()`` prices the design space at a nominal batch; the router
    batches dynamically, so dispatch re-prices each flush with the real
    occupancy.  Returns ``(latency_s, energy_j)``.
    """
    lat = energy = 0.0
    for lo, hi, prof_name in plan.assignments:
        prof = get_profile(prof_name)
        entry = layers[lo].act_in_elems if lo > 0 else 0.0
        c = segment_cost(layers[lo:hi], prof, batch, entry_act_elems=entry)
        lat += c.latency_s
        energy += c.energy_j
    return lat, energy


def reschedule_over_subset(layers: Sequence[LayerCost],
                           profile_names: Sequence[str],
                           lost: Iterable[str] = (),
                           batch: int = 1,
                           max_segments: int = 2,
                           accuracy_penalty: Optional[Dict[str, float]] = None,
                           cut_candidates: Optional[Sequence[int]] = None
                           ) -> List[ScheduledPlan]:
    """Failover path: re-run the search over the surviving profile subset.

    Simply *filtering* an existing frontier is not enough — dropping a
    lost profile's plans can resurrect survivor-only plans they used to
    dominate — so the frontier must be recomputed from scratch (cheap now
    that ``pareto_frontier`` is a skyline sweep).  Returns ``[]`` when no
    profile survives.
    """
    lost_set = set(lost)
    surviving = [p for p in profile_names if p not in lost_set]
    if not surviving:
        return []
    return schedule(layers, surviving, batch=batch,
                    max_segments=max_segments,
                    accuracy_penalty=accuracy_penalty,
                    cut_candidates=cut_candidates)


def mpai_reference_plan(layers: Sequence[LayerCost], batch: int = 1,
                        head_layers: int = 1) -> ScheduledPlan:
    """The paper's deployed configuration: everything but the head on the
    INT8 DPU, the head on the FP16 VPU."""
    cut = len(layers) - head_layers
    return _plan_cost(layers, [cut], ["mpsoc_dpu", "myriadx_vpu"], batch,
                      {"mpsoc_dpu": 0.05})   # QAT'd backbone: measured ~small
