"""Accelerator profiles — the heterogeneity MPAI schedules against (the
port's copy of ``repro.core.accelerators``, names and values unchanged:
the router prices plans and decides dispatch on the virtual clock from
them, so a fleet spec must decide alike in both packages).

The paper's four devices are reproduced from their datasheets / the
paper's own numbers so that Table I and Fig. 2 can be re-derived from the
roofline cost model; the TPU v5e profiles are the deployment targets of
the reference framework (per-precision operating points of the same chip
— MPAI's "different accelerators" generalizes to "different operating
points of a homogeneous pod").  No H100 operating point is defined yet.

Peak numbers:
  * DPUCZDX8G on ZCU104 (2x B4096 @ ~300 MHz): ~2.4 TOPS INT8, DDR4 ~19 GB/s
  * MyriadX NCS2: ~1 TOPS effective FP16 (4 TOPS marketing peak derated to
    the sustained DNN rate the paper observes), LPDDR4 ~8.5 GB/s (on-chip
    2.5 MB CMX buffers most reuse)
  * Edge TPU: 4 TOPS INT8, ~8 MB on-chip SRAM, LPDDR4 ~4 GB/s off-chip
  * Cortex-A53 quad @1.2-1.5 GHz: ~10-20 GFLOP/s NEON
  * TPU v5e: 197 TFLOP/s bf16 / 394 TOPS int8, 819 GB/s HBM, ~50 GB/s/link
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.precision import Precision


@dataclass(frozen=True)
class AcceleratorProfile:
    name: str
    precision: Precision
    peak_ops: float           # ops/s at `precision` (MAC = 2 ops)
    mem_bw: float             # bytes/s to its activation/weight store
    link_bw: float            # bytes/s to the host / peer (handoff cost)
    power_w: float            # board-level active power
    efficiency: float = 0.6   # sustained fraction of peak on DNN layers
    overhead_s: float = 0.0   # per-inference dispatch/transfer latency
    depthwise_eff: float = 1.0  # MAC utilization on depthwise/grouped convs
    weight_bw: float = 0.0    # weight-fetch bandwidth (0 -> mem_bw); models
    #   the Edge TPU's off-chip weight spill when a model exceeds its SRAM

    @property
    def sustained_ops(self) -> float:
        return self.peak_ops * self.efficiency


GB = 1e9
T = 1e12

# Efficiencies are CALIBRATED against the paper's own Table I effective
# rates (UrsoNet latency -> sustained ops/s): Cortex-A53 ~3 GFLOP/s fp32,
# VPU ~120 GFLOP/s fp16 (246 ms), Edge TPU ~200 GOP/s with DDR spill
# (149 ms), DPU ~560 GOP/s (53 ms).  overhead_s models per-inference
# dispatch + host transfer (dominates small nets on USB devices — the
# Fig. 2 MobileNet crossover).
PROFILES: Dict[str, AcceleratorProfile] = {
    # --- the paper's devices (for Table I / Fig. 2 reproduction) -----------
    "cortex_a53": AcceleratorProfile(
        "cortex_a53", Precision.FP32, 12e9, 4 * GB, 1 * GB, 4.0, 0.25),
    "cortex_a53_fp16": AcceleratorProfile(
        "cortex_a53_fp16", Precision.FP16, 24e9, 4 * GB, 1 * GB, 4.0, 0.29),
    "myriadx_vpu": AcceleratorProfile(
        "myriadx_vpu", Precision.FP16, 1.0 * T, 8.5 * GB, 0.4 * GB, 2.0,
        0.12, overhead_s=1.5e-3, depthwise_eff=0.1),
    "edge_tpu": AcceleratorProfile(
        "edge_tpu", Precision.INT8, 4.0 * T, 4.0 * GB, 0.3 * GB, 2.0,
        0.5, overhead_s=1.8e-3, depthwise_eff=0.5),
    "mpsoc_dpu": AcceleratorProfile(
        "mpsoc_dpu", Precision.INT8, 4.9 * T, 19.2 * GB, 12.8 * GB, 10.0,
        0.115, overhead_s=2e-4, depthwise_eff=0.25),
    # --- deployment target: TPU v5e per-precision operating points ---------
    "tpu_v5e_bf16": AcceleratorProfile(
        "tpu_v5e_bf16", Precision.BF16, 197e12, 819 * GB, 50 * GB, 170.0, 0.55),
    "tpu_v5e_int8": AcceleratorProfile(
        "tpu_v5e_int8", Precision.INT8, 394e12, 819 * GB, 50 * GB, 170.0, 0.55),
    "tpu_v5e_fp32": AcceleratorProfile(
        "tpu_v5e_fp32", Precision.FP32, 49e12, 819 * GB, 50 * GB, 170.0, 0.55),
}


def get_profile(name: str) -> AcceleratorProfile:
    return PROFILES[name]


# Accuracy priors for the scheduler (relative error-budget units): what the
# paper's Table I encodes empirically — INT8 PTQ hurts, FP16 is near-lossless,
# QAT recovers most of INT8's loss.  Used as a *prior* when no measured
# accuracy is supplied.
PRECISION_ERROR_PRIOR = {
    Precision.FP32: 0.0,
    Precision.BF16: 0.01,
    Precision.FP16: 0.01,
    Precision.INT8: 0.30,     # PTQ prior; QAT-trained segments pass measured
}
