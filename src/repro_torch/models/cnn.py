"""UrsoNet — the paper's benchmark workload (satellite pose estimation,
Proenca & Gao, ICRA 2020) — plus analytic layer tables for the Fig. 2
networks (MobileNetV2 / ResNet-50 / InceptionV4) used by the cost model:
the port of ``repro.models.cnn``.

UrsoNet here: ResNet-style backbone (stem + 4 stages of residual blocks,
GroupNorm) with two heads — location regression [3] and orientation
quaternion [4].  The MPAI partition splits exactly where the paper does:
convolutional backbone -> INT8 engine, FC heads -> bf16 engine.

The parameter tree is the reference's (HWIO conv weights, dicts with lists
of stage blocks; activations NHWC at the interface), so
``bridge.to_torch`` carries the reference's weights over.  Convolutions
honour the precision policy as the reference's do: quantize-dequantize of
weights and activations (fake: with a straight-through gradient) around a
``conv2d`` in the policy's compute dtype.  The reference computes them with
``lax.conv_general_dilated``, XLA code outside any Pallas kernel, so the
port calls ``torch.nn.functional.conv2d``; the FC heads go through
``pdot``, whose quant mode is the int8 GEMM kernel on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.quantization import fake_quant, pdot, quantize
from repro_torch.models.layers import silu


# ---------------------------------------------------------------------------
# Policy-aware conv
# ---------------------------------------------------------------------------
def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis: the output is
    ``ceil(size / stride)`` and the extra pad goes after (so a stride-2
    conv on an even size pads (k//2 - 1, k//2))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def pconv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """x: [B,H,W,Cin]; w: [kh,kw,Cin,Cout] — NHWC/HWIO, ``"SAME"``
    padding."""
    if policy.mode == "fake":
        w = fake_quant(w, channel_axis=-1)
        x = fake_quant(x)
    elif policy.mode == "quant":
        w = quantize(w, channel_axis=-1).dequantize(torch.bfloat16)
        x = quantize(x).dequantize(torch.bfloat16)
    dt = policy.precision.compute_dtype
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    # operands rounded to the compute dtype, products summed in f32 and the
    # sum rounded once, as XLA runs a bf16 conv (oneDNN's bf16 conv rounds
    # otherwise on the CPU; on the card cuDNN's f32 conv takes the same
    # bf16 values, so TF32, were it on, would round nothing)
    xc = F.pad(x.to(dt).float().permute(0, 3, 1, 2),
               (left, right, top, bottom))
    out = F.conv2d(xc, w.to(dt).float().permute(3, 2, 0, 1), stride=stride)
    return out.to(dt).permute(0, 2, 3, 1)


def group_norm(params: Dict, x: torch.Tensor, groups: int = 8,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over ``gcd(groups, C)`` groups of an NHWC tensor, in f32
    with the population variance, cast back to ``x``'s dtype."""
    b, h, w, c = x.shape
    g = math.gcd(groups, c)
    xf = x.float().reshape(b, h, w, g, c // g)
    mu = torch.mean(xf, dim=(1, 2, 4), keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=(1, 2, 4), keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf.reshape(b, h, w, c) * params["scale"]
            + params["bias"]).to(x.dtype)


def _gn_init(c: int, device) -> Dict:
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def _conv_init(generator: torch.Generator, kh, kw, cin, cout,
               device) -> torch.Tensor:
    fan = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=generator,
                       dtype=torch.float32, device=device) / math.sqrt(fan)


def _dense_init(generator: torch.Generator, fan_in: int, fan_out: int,
                device) -> torch.Tensor:
    """N(0, 1/fan_in) f32, as the reference's ``layers.dense_init``."""
    return torch.randn((fan_in, fan_out), generator=generator,
                       dtype=torch.float32, device=device) * fan_in ** -0.5


# ---------------------------------------------------------------------------
# UrsoNet
# ---------------------------------------------------------------------------
class UrsoNetConfig(NamedTuple):
    name: str = "ursonet"
    image_hw: Tuple[int, int] = (192, 256)      # backbone input (paper resamples 1280x960)
    widths: Tuple[int, ...] = (32, 64, 128, 256)
    blocks_per_stage: int = 2
    fc_dim: int = 256

    @property
    def num_layers(self) -> int:                 # conv stages as "layers"
        return len(self.widths) * self.blocks_per_stage


def ursonet_init(generator: torch.Generator, cfg: UrsoNetConfig,
                 device="cuda") -> Dict:
    """Random f32 weights on ``device`` from ``generator`` (the port's own
    draws: the reference's tree and scales, not its values)."""
    p: Dict = {"stem": {"w": _conv_init(generator, 7, 7, 3, cfg.widths[0],
                                        device),
                        "gn": _gn_init(cfg.widths[0], device)},
               "stages": []}
    cin = cfg.widths[0]
    for w_ in cfg.widths:
        stage = []
        for _ in range(cfg.blocks_per_stage):
            blk = {"w1": _conv_init(generator, 3, 3, cin, w_, device),
                   "gn1": _gn_init(w_, device),
                   "w2": _conv_init(generator, 3, 3, w_, w_, device),
                   "gn2": _gn_init(w_, device)}
            if cin != w_:
                blk["proj"] = _conv_init(generator, 1, 1, cin, w_, device)
            stage.append(blk)
            cin = w_
        p["stages"].append(stage)
    p["fc"] = _dense_init(generator, cin, cfg.fc_dim, device)
    p["head_loc"] = _dense_init(generator, cfg.fc_dim, 3, device)
    p["head_ori"] = _dense_init(generator, cfg.fc_dim, 4, device)
    return p


def ursonet_apply(params: Dict, cfg: UrsoNetConfig, images: torch.Tensor,
                  backbone_policy: PrecisionPolicy = DEFAULT_POLICY,
                  head_policy: PrecisionPolicy = DEFAULT_POLICY
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images: [B, H, W, 3] -> (loc [B,3], quat [B,4] normalized).

    ``backbone_policy`` / ``head_policy`` are the MPAI partition: conv
    backbone on the INT8 engine, FC heads on the high-precision engine.
    """
    x = images.to(torch.bfloat16)
    x = pconv(x, params["stem"]["w"], 2, backbone_policy)
    x = silu(group_norm(params["stem"]["gn"], x))
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if bi == 0 and si > 0 else 1
            h = pconv(x, blk["w1"], stride, backbone_policy)
            h = silu(group_norm(blk["gn1"], h))
            h = pconv(h, blk["w2"], 1, backbone_policy)
            h = group_norm(blk["gn2"], h)
            sc = x
            if "proj" in blk:
                sc = pconv(x, blk["proj"], 1, backbone_policy)
            if stride == 2:
                sc = sc[:, ::2, ::2]
            x = silu(h + sc)
    # global average pool, summed in f32 as jnp.mean does for bf16
    feat = torch.mean(x.float(), dim=(1, 2)).to(x.dtype)
    feat = silu(pdot(feat, params["fc"], head_policy))
    loc = pdot(feat, params["head_loc"], head_policy).float()
    scale, offset = _loc_norm(loc.device)
    loc = loc * scale + offset
    q = pdot(feat, params["head_ori"], head_policy).float()
    q = q / torch.clamp_min(torch.sqrt(torch.sum(q * q, dim=-1,
                                                 keepdim=True)), 1e-8)
    return loc, q


# location normalization (matches the synthetic task's pose distribution)
LOC_OFFSET = torch.tensor([0.0, 0.0, 16.0], dtype=torch.float32)
LOC_SCALE = torch.tensor([3.0, 2.0, 8.0], dtype=torch.float32)
_LOC_NORM: Dict = {}


def _loc_norm(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LOC_SCALE, LOC_OFFSET) on ``device``, copied there once (a copy
    from pageable host memory waits for the stream)."""
    if device not in _LOC_NORM:
        _LOC_NORM[device] = LOC_SCALE.to(device), LOC_OFFSET.to(device)
    return _LOC_NORM[device]


def pose_loss(loc, q, loc_gt, q_gt) -> torch.Tensor:
    scale = _loc_norm(loc.device)[0]
    l_loc = torch.mean(torch.sum(torch.square((loc - loc_gt) / scale),
                                 dim=-1))
    dot = torch.sum(q * q_gt, dim=-1)
    l_ori = torch.mean(1.0 - torch.square(dot))
    return l_loc + 4.0 * l_ori


def pose_metrics(loc, q, loc_gt, q_gt) -> Tuple[torch.Tensor, torch.Tensor]:
    """(LOCE meters, ORIE degrees) — the paper's Table I metrics."""
    loce = torch.mean(torch.sqrt(torch.sum(torch.square(loc - loc_gt),
                                           dim=-1)))
    dot = torch.clamp(torch.abs(torch.sum(q * q_gt, dim=-1)), 0.0, 1.0)
    orie = torch.mean(2.0 * torch.arccos(dot)) * 180.0 / math.pi
    return loce, orie


# ---------------------------------------------------------------------------
# Analytic conv tables for Fig. 2 (cost-model inputs; not executed)
# ---------------------------------------------------------------------------
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


def mobilenet_v2_layers() -> List[ConvLayerSpec]:
    """224x224 input; inverted residuals (expansion 6)."""
    layers = [_conv_macs(224, 3, 3, 32, 2)]
    spec = [(16, 1, 1, 112), (24, 6, 2, 112), (24, 6, 1, 56), (32, 6, 2, 56),
            (32, 6, 1, 28), (32, 6, 1, 28), (64, 6, 2, 28), (64, 6, 1, 14),
            (64, 6, 1, 14), (64, 6, 1, 14), (96, 6, 1, 14), (96, 6, 1, 14),
            (96, 6, 1, 14), (160, 6, 2, 14), (160, 6, 1, 7), (160, 6, 1, 7),
            (320, 6, 1, 7)]
    cin = 32
    for cout, t, s, hw in spec:
        mid = cin * t
        layers += [_conv_macs(hw, 1, cin, mid),
                   _conv_macs(hw, 3, mid, mid, s, groups=mid),
                   _conv_macs(hw // s, 1, mid, cout)]
        cin = cout
    layers.append(_conv_macs(7, 1, 320, 1280))
    layers.append(ConvLayerSpec("fc", 1280 * 1000, 1280 * 1000, 1000))
    return layers


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


def inception_v4_layers() -> List[ConvLayerSpec]:
    """Coarse 299x299 Inception-V4 (~12.3 GMACs total, matching published)."""
    layers = [_conv_macs(299, 3, 3, 32, 2), _conv_macs(149, 3, 32, 32),
              _conv_macs(149, 3, 32, 64)]
    for _ in range(4):                                   # Inception-A x4
        layers += [_conv_macs(35, 1, 384, 96), _conv_macs(35, 3, 96, 96),
                   _conv_macs(35, 3, 96, 96), _conv_macs(35, 1, 384, 96)]
    for _ in range(7):                                   # Inception-B x7
        layers += [_conv_macs(17, 1, 1024, 192), _conv_macs(17, 7, 192, 224),
                   _conv_macs(17, 7, 224, 256), _conv_macs(17, 1, 1024, 384)]
    for _ in range(3):                                   # Inception-C x3
        layers += [_conv_macs(8, 1, 1536, 256), _conv_macs(8, 3, 256, 512),
                   _conv_macs(8, 1, 1536, 256)]
    layers.append(ConvLayerSpec("fc", 1536 * 1000, 1536 * 1000, 1000))
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


def ursonet_layers(cfg: UrsoNetConfig = UrsoNetConfig()) -> List[ConvLayerSpec]:
    h, w = cfg.image_hw
    layers = [_conv_macs(max(h, w), 7, 3, cfg.widths[0], 2)]
    hw = max(h, w) // 2
    cin = cfg.widths[0]
    for si, w_ in enumerate(cfg.widths):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if b == 0 and si > 0 else 1
            layers += [_conv_macs(hw, 3, cin, w_, stride),
                       _conv_macs(hw // stride, 3, w_, w_)]
            hw //= stride
            cin = w_
    layers.append(ConvLayerSpec("fc", cin * cfg.fc_dim, cin * cfg.fc_dim,
                                cfg.fc_dim))
    layers.append(ConvLayerSpec("heads", cfg.fc_dim * 7, cfg.fc_dim * 7, 7))
    return layers
