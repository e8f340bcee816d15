"""Network partitioning — the MPAI contribution's structural half.

A :class:`PartitionPlan` splits a layered network into contiguous
:class:`Segment`s, each pinned to a precision policy and (logically) an
accelerator profile.  The paper's deployed configuration is the two-way
split — compute-heavy backbone on the INT8 engine, accuracy-critical head
on the FP16 engine — which :meth:`PartitionPlan.mpai` reproduces for any
layer count.  Plans are frozen and hashable, and each segment runs its
layers under its own policy, so a partition boundary is where the model's
layer loop switches precision.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.core.precision import PrecisionPolicy


@dataclass(frozen=True)
class Segment:
    name: str
    start: int                       # first layer (inclusive)
    end: int                         # last layer (exclusive)
    policy: PrecisionPolicy
    accelerator: str = "tpu_v5e_bf16"  # cost-model profile / stage assignment

    @property
    def num_layers(self) -> int:
        return self.end - self.start


@dataclass(frozen=True)
class PartitionPlan:
    segments: Tuple[Segment, ...]
    embed_policy: PrecisionPolicy = field(default_factory=PrecisionPolicy.bf16)
    head_policy: PrecisionPolicy = field(default_factory=PrecisionPolicy.bf16)

    def validate(self, num_layers: int, period: int = 1) -> None:
        segs = self.segments
        if not segs:
            raise ValueError("empty plan")
        if segs[0].start != 0 or segs[-1].end != num_layers:
            raise ValueError(f"plan does not cover [0, {num_layers})")
        for a, b in zip(segs, segs[1:]):
            if a.end != b.start:
                raise ValueError(f"segments {a.name}/{b.name} not contiguous")
        for s in segs:
            if s.num_layers <= 0:
                raise ValueError(f"segment {s.name} is empty")
            if s.start % period or s.end % period:
                raise ValueError(
                    f"segment {s.name} [{s.start},{s.end}) not aligned to the "
                    f"layer-pattern period {period}")

    # ------------------------------------------------------------------
    # canonical plans
    # ------------------------------------------------------------------
    @classmethod
    def uniform(cls, num_layers: int, policy: PrecisionPolicy | None = None,
                accelerator: str = "tpu_v5e_bf16") -> "PartitionPlan":
        policy = policy or PrecisionPolicy.bf16()
        return cls((Segment("all", 0, num_layers, policy, accelerator),),
                   embed_policy=policy if not policy.precision.is_quantized
                   else PrecisionPolicy.bf16(),
                   head_policy=policy if not policy.precision.is_quantized
                   else PrecisionPolicy.bf16())

    @classmethod
    def mpai(cls, num_layers: int, split: int | None = None,
             mode: str = "fake", use_pallas: bool = False) -> "PartitionPlan":
        """The paper's deployment: int8 backbone + high-precision head.

        ``split``: layer index where the high-precision tail begins
        (default: last layer only — the transformer analogue of UrsoNet's
        FC heads).  ``mode``: 'fake' (QAT training) or 'quant' (serving).
        """
        split = num_layers - 1 if split is None else split
        split = max(1, min(split, num_layers))
        int8 = (PrecisionPolicy.int8_qat() if mode == "fake"
                else PrecisionPolicy.int8(use_pallas=use_pallas))
        segs = [Segment("backbone", 0, split, int8, "tpu_v5e_int8")]
        if split < num_layers:
            segs.append(Segment("head", split, num_layers,
                                PrecisionPolicy.bf16(), "tpu_v5e_bf16"))
        return cls(tuple(segs))

    def align_to_period(self, period: int, num_layers: int) -> "PartitionPlan":
        """Snap segment boundaries to multiples of the layer-pattern period."""
        if period <= 1:
            return self
        snap = lambda x: max(period, min((x // period) * period, num_layers))
        segs, prev = [], 0
        for s in self.segments[:-1]:
            e = snap(s.end)
            if e > prev:
                segs.append(Segment(s.name, prev, e, s.policy, s.accelerator))
                prev = e
        last = self.segments[-1]
        if prev < num_layers:
            segs.append(Segment(last.name, prev, num_layers, last.policy,
                                last.accelerator))
        return PartitionPlan(tuple(segs), self.embed_policy, self.head_policy)

