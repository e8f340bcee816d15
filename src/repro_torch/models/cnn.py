"""Analytic conv layer tables for the cost model (the port's copy of the
tables in ``repro.models.cnn``).

``ursonet_table1_layers`` is the paper's Table I workload: the default
``FleetSpec.workload`` (``"ursonet"``) prices its router frontier over
these layers.  The tables are data, not executed.  The UrsoNet network
itself (the policy-aware ``pconv`` and the GroupNorm ResNet backbone with
its loc and quat heads) and the other Fig. 2 tables are not ported yet
(ROADMAP.md, port queue item 9).
"""
from __future__ import annotations

from typing import List, NamedTuple


class ConvLayerSpec(NamedTuple):
    name: str
    macs: float           # multiply-accumulates per image
    params: float         # weights
    activations: float    # output activation elements
    kind: str = "dense"


def _conv_macs(hw: int, k: int, cin: int, cout: int, stride: int = 1,
               groups: int = 1) -> ConvLayerSpec:
    out = hw // stride
    macs = out * out * k * k * cin * cout / groups
    return ConvLayerSpec(f"conv{k}x{k}_{cin}-{cout}", macs,
                         k * k * cin * cout / groups, out * out * cout,
                         kind="depthwise" if groups > 1 else "dense")


def resnet50_layers() -> List[ConvLayerSpec]:
    layers = [_conv_macs(224, 7, 3, 64, 2)]
    cfgs = [(64, 256, 3, 56), (128, 512, 4, 28), (256, 1024, 6, 14),
            (512, 2048, 3, 7)]
    cin = 64
    for mid, cout, n, hw in cfgs:
        for i in range(n):
            layers += [_conv_macs(hw, 1, cin, mid),
                       _conv_macs(hw, 3, mid, mid),
                       _conv_macs(hw, 1, mid, cout)]
            cin = cout
    layers.append(ConvLayerSpec("fc", 2048 * 1000, 2048 * 1000, 1000))
    return layers


def ursonet_table1_layers() -> List[ConvLayerSpec]:
    """Full-size UrsoNet as benchmarked in Table I: ResNet-50 backbone on
    the 1280x960 input resampled to ~384x512 (the UrsoNet paper's bottleneck
    resolution), plus the pose FC heads.  Spatial MACs/activations scale
    by (384*512)/(224*224) vs the ImageNet table."""
    scale = (384 * 512) / (224 * 224)
    layers = []
    for l in resnet50_layers()[:-1]:                     # conv backbone
        layers.append(ConvLayerSpec(l.name, l.macs * scale, l.params,
                                    l.activations * scale, l.kind))
    layers.append(ConvLayerSpec("fc_pose", 2048 * 512, 2048 * 512, 512))
    layers.append(ConvLayerSpec("heads", 512 * 7, 512 * 7, 7))
    return layers
