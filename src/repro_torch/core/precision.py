"""Precision lattice and execution policies (the MPAI precision axis).

The paper's accelerators define three operating precisions — INT8 (DPU,
Edge TPU), FP16 (MyriadX VPU) and FP32 (Cortex CPUs).  The fast float of
the port is bf16, so FP16 policies map to bf16; INT8 maps to the int8 GEMM
kernel ``kernels/int8_matmul.py``.

A :class:`PrecisionPolicy` tells a model segment *how to execute its
matmuls*; it is threaded through the model code via ``pdot`` (see
``core/quantization.py``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class Precision(enum.Enum):
    INT8 = "int8"
    FP16 = "fp16"       # executed as bf16
    BF16 = "bf16"
    FP32 = "fp32"

    @property
    def compute_dtype(self) -> torch.dtype:
        if self is Precision.FP32:
            return torch.float32
        return torch.bfloat16  # int8 path dequantizes into bf16

    @property
    def bytes_per_weight(self) -> float:
        if self is Precision.INT8:
            return 1.0
        return 4.0 if self is Precision.FP32 else 2.0

    @property
    def is_quantized(self) -> bool:
        return self is Precision.INT8


@dataclass(frozen=True)
class PrecisionPolicy:
    """How a segment executes.

    mode:
      * ``raw``   — plain matmul in ``precision.compute_dtype``
      * ``fake``  — fake-quant (QAT training of int8 segments, gradients
                    passed straight through)
      * ``quant`` — real int8 execution (per-channel weight scales, dynamic
                    per-tensor activation quantization)

    ``use_pallas`` keeps the reference's field so plans compare equal; the
    port sends every CUDA int8 product through its kernel either way.
    """
    precision: Precision = Precision.BF16
    mode: str = "raw"
    per_channel: bool = True          # weight scales per output channel
    use_pallas: bool = False

    def __post_init__(self):
        if self.mode in ("fake", "quant") and self.precision is not Precision.INT8:
            raise ValueError("fake/quant modes are int8-only")

    @classmethod
    def bf16(cls) -> "PrecisionPolicy":
        return cls(Precision.BF16, "raw")

    @classmethod
    def fp32(cls) -> "PrecisionPolicy":
        return cls(Precision.FP32, "raw")

    @classmethod
    def int8_qat(cls) -> "PrecisionPolicy":
        return cls(Precision.INT8, "fake")

    @classmethod
    def int8(cls, use_pallas: bool = False) -> "PrecisionPolicy":
        return cls(Precision.INT8, "quant", use_pallas=use_pallas)


DEFAULT_POLICY = PrecisionPolicy.bf16()
