"""Plan conversion for serving (the port of ``repro.core.qat``).

Partition-aware training (the paper's §III) trains the int8 segments of a
plan with fake quantization; serving runs them truly quantized.  The port
serves, so it keeps the serve conversion; the training conversions come
with the training slice.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.partition import PartitionPlan, Segment
from repro_torch.core.precision import Precision


def serve_plan(plan: PartitionPlan, use_pallas: bool = False) -> PartitionPlan:
    """int8 segments -> real int8 execution."""
    segs = []
    for s in plan.segments:
        if s.policy.precision is Precision.INT8:
            pol = dataclasses.replace(s.policy, mode="quant",
                                      use_pallas=use_pallas)
            segs.append(Segment(s.name, s.start, s.end, pol, s.accelerator))
        else:
            segs.append(s)
    return PartitionPlan(tuple(segs), plan.embed_policy, plan.head_policy)
