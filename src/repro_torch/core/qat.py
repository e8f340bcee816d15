"""Partition-aware training (the paper's §III key enabler): the port of
``repro.core.qat``.

The model is trained *knowing the deployment partition*: segments that
will execute on an INT8 engine train with fake quantization (a
straight-through gradient), so the quantized pipeline recovers baseline
accuracy — Table I's DPU+VPU row.

This module converts between the three lifecycle phases of a plan:

  train  (int8 segments -> fake-quant)   ->  serve (int8 -> real quant)
                                          ->  eval  (any -> raw bf16 baseline)
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.partition import PartitionPlan, Segment
from repro_torch.core.precision import Precision, PrecisionPolicy


def _convert(plan: PartitionPlan, mode: str,
             use_pallas: bool = False) -> PartitionPlan:
    segs = []
    for s in plan.segments:
        if s.policy.precision is Precision.INT8:
            pol = dataclasses.replace(s.policy, mode=mode,
                                      use_pallas=use_pallas and mode == "quant")
            segs.append(Segment(s.name, s.start, s.end, pol, s.accelerator))
        else:
            segs.append(s)
    return PartitionPlan(tuple(segs), plan.embed_policy, plan.head_policy)


def train_plan(plan: PartitionPlan) -> PartitionPlan:
    """int8 segments -> fake-quant (QAT)."""
    return _convert(plan, "fake")


def serve_plan(plan: PartitionPlan, use_pallas: bool = False) -> PartitionPlan:
    """int8 segments -> real int8 execution."""
    return _convert(plan, "quant", use_pallas)


def baseline_plan(plan: PartitionPlan) -> PartitionPlan:
    """Strip quantization everywhere (the fp32/bf16 reference rows)."""
    segs = tuple(Segment(s.name, s.start, s.end, PrecisionPolicy.bf16(),
                         "tpu_v5e_bf16") for s in plan.segments)
    return PartitionPlan(segs, PrecisionPolicy.bf16(), PrecisionPolicy.bf16())
