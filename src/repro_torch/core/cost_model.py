"""Three-term roofline cost model over accelerator profiles (the port's
copy of ``repro.core.cost_model``).

latency(segment, profile) = max(compute, memory) + handoff
  compute = 2 * MACs / sustained_ops
  memory  = (weight_bytes + activation_bytes) / mem_bw
  handoff = boundary activation bytes / link_bw      (charged at segment entry)

energy = power * latency  (+ link energy folded into power)

The same machinery prices (a) the paper's CNN layer tables on the paper's
devices (Table I / Fig. 2 reproduction) and (b) transformer segments on
TPU profiles (scheduler input).  Precision changes both the ops rate
(profile) and the bytes moved (weights shrink to 1 B for INT8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.accelerators import AcceleratorProfile
from repro_torch.core.precision import Precision


@dataclass(frozen=True)
class SegmentCost:
    name: str
    compute_s: float
    memory_s: float
    handoff_s: float
    energy_j: float

    @property
    def latency_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.handoff_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "handoff": self.handoff_s}
        return max(terms, key=terms.get)


@dataclass(frozen=True)
class LayerCost:
    """Workload description of one layer (precision-independent)."""
    name: str
    macs: float
    weight_elems: float
    act_in_elems: float
    act_out_elems: float
    kind: str = "dense"       # dense | depthwise (poor MAC utilization)


def layer_costs_from_convspecs(specs) -> List[LayerCost]:
    out, prev_act = [], 0.0
    for s in specs:
        out.append(LayerCost(s.name, s.macs, s.params,
                             prev_act or s.activations, s.activations,
                             kind=getattr(s, "kind", "dense")))
        prev_act = s.activations
    return out


def segment_cost(layers: Sequence[LayerCost], profile: AcceleratorProfile,
                 batch: int = 1, entry_act_elems: float = 0.0,
                 act_bytes: float | None = None) -> SegmentCost:
    """Price a contiguous run of layers on one accelerator."""
    wbytes = profile.precision.bytes_per_weight
    abytes = act_bytes if act_bytes is not None else (
        1.0 if profile.precision is Precision.INT8 else 2.0)
    dw_eff = getattr(profile, "depthwise_eff", 1.0)
    macs_eff = sum(l.macs / (dw_eff if l.kind == "depthwise" else 1.0)
                   for l in layers) * batch
    weight_b = sum(l.weight_elems for l in layers) * wbytes
    act_b = sum(l.act_in_elems + l.act_out_elems for l in layers) * batch * abytes
    compute = 2.0 * macs_eff / profile.sustained_ops
    wbw = getattr(profile, "weight_bw", 0.0) or profile.mem_bw
    memory = weight_b / wbw + act_b / profile.mem_bw
    handoff = (entry_act_elems * batch * abytes) / profile.link_bw \
        + profile.overhead_s
    lat = max(compute, memory) + handoff
    return SegmentCost("+".join(l.name for l in layers[:1]) +
                       (f"..x{len(layers)}" if len(layers) > 1 else ""),
                       compute, memory, handoff, profile.power_w * lat)


def network_latency(layers: Sequence[LayerCost], profile: AcceleratorProfile,
                    batch: int = 1) -> SegmentCost:
    return segment_cost(layers, profile, batch)


def fps(layers: Sequence[LayerCost], profile: AcceleratorProfile) -> float:
    return 1.0 / network_latency(layers, profile).latency_s


# ---------------------------------------------------------------------------
# Transformer layer tables (scheduler input for the assigned archs)
# ---------------------------------------------------------------------------
def transformer_layer_costs(cfg, seq_len: int) -> List[LayerCost]:
    """Per-layer MACs/weights/activations for one sample of length S."""
    d, f, s = cfg.d_model, cfg.d_ff, seq_len
    hd = cfg.resolved_head_dim()
    out: List[LayerCost] = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_mixer(i)
        macs = w = 0.0
        if kind == "attention":
            qo = d * cfg.num_heads * hd
            kv = d * cfg.num_kv_heads * hd
            w += 2 * qo + 2 * kv
            macs += s * (2 * qo + 2 * kv)
            eff_s = min(s, cfg.sliding_window) if cfg.sliding_window else s
            macs += 2 * s * eff_s * cfg.num_heads * hd / 2  # causal halves it
        elif kind == "mamba":
            mc = cfg.mamba
            di = mc.expand * d
            w += 3 * d * di + di * (mc.resolved_dt_rank(d) + 2 * mc.d_state)
            macs += s * (3 * d * di + di * mc.d_state * 2)
        elif kind == "rwkv6":
            w += 6 * d * d
            macs += s * (6 * d * d + d * 64)
        if cfg.is_moe_layer(i):
            e = cfg.moe
            per = d * e.d_ff_expert * (3 if cfg.glu else 2)
            w += e.num_experts * per
            macs += s * e.top_k * per
        elif kind != "rwkv6":
            w += d * f * (3 if cfg.glu else 2)
            macs += s * d * f * (3 if cfg.glu else 2)
        else:
            w += 3 * d * f
            macs += s * 3 * d * f
        out.append(LayerCost(f"layer_{i}", macs, w, s * d, s * d))
    return out
