#!/usr/bin/env python3
"""Where a UrsoNet training step of the PyTorch port goes, on one card.

    python3 scripts/pose_breakdown.py

Trains UrsoNet at ``configs/ursonet.FULL`` (192 x 256, widths 32-256, 2
blocks a stage, fc 256; the port's seed-0 init) on batches of 16 under the
``"fp32"`` and ``"mpai"`` training policies of ``repro_torch.pose`` (bf16
backbone, or fake-quantized int8 backbone with a bf16 head) and prints one
JSON line per condition:

- ``step_ms``: wall time of one ``pose.train_step`` (loss, backward, AdamW)
  ending in a synchronize, median of 10;
- ``enqueue_ms``: host time until ``train_step`` returns, without the
  synchronize: near ``step_ms``, the card waits on the host;
- ``forward_ms`` / ``forward_enqueue_ms``: the same for the forward and
  loss alone (no gradient), and ``forward_device_ms`` for that forward
  captured in a CUDA graph and replayed (no host time between kernels);
- ``adamw_ms`` / ``adamw_device_ms``: ``adamw.apply_updates`` eager and
  replayed from a CUDA graph;
- ``data_ms`` / ``data_device_ms``: ``pose_batch`` (16 images) the same way;
- ``convs_f32_device_ms`` / ``convs_bf16_device_ms``: every convolution of
  the forward at its shapes, as the port runs a bf16 one (``pconv``: f32 on
  bf16 values, TF32 off) and as a bf16 cuDNN convolution, each replayed
  from a CUDA graph and summed; ``convs_policy_device_ms`` the same convs
  through ``pconv`` under the condition's backbone policy (``"mpai"``: the
  fake quantization of weights and activations included);
- ``bound_ms``: the step's operations at the bf16 tensor-core peak
  (``ursonet_macs`` in ``chip_smoke.py``).

Needs one card; builds no kernel (the training path runs none).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PEAK_BF16_FLOPS = 989e12
BATCH = 16


def graph_ms(fn, reps: int = 10) -> float:
    """Median device time of one ``fn()`` captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return float(np.median(times))


def wall_ms(fn, reps: int = 10, sync: bool = True) -> float:
    """Median host time of ``fn()``, to the end of its device work with
    ``sync``, else until it returns."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def conv_shapes(cfg):
    """(H, W, Cin, Cout, k, stride) of every convolution of the forward."""
    ceil = lambda a, b: -(-a // b)
    h, w = cfg.image_hw
    out = [(h, w, 3, cfg.widths[0], 7, 2)]
    h, w, cin = ceil(h, 2), ceil(w, 2), cfg.widths[0]
    for si, width in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            stride = 2 if bi == 0 and si > 0 else 1
            if cin != width:
                out.append((h, w, cin, width, 1, 1))
            out.append((h, w, cin, width, 3, stride))
            h, w = ceil(h, stride), ceil(w, stride)
            out.append((h, w, width, width, 3, 1))
            cin = width
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("pose_breakdown: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ursonet_macs
    from repro_torch import pose
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.ursonet import FULL
    from repro_torch.core.precision import PrecisionPolicy as P
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import pose_batch
    from repro_torch.models import cnn
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = FULL
    bound = 2 * ursonet_macs(cfg)["train"] * BATCH / PEAK_BF16_FLOPS * 1e3
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=200,
                     weight_decay=0.0, grad_clip=1.0)
    batch = pose_batch(BATCH, 0, image_hw=cfg.image_hw, device=dev)
    args = (batch["images"], batch["loc"], batch["quat"])
    g = torch.Generator(device=dev).manual_seed(7)
    convs = []
    for h, w, cin, cout, k, s in conv_shapes(cfg):
        x = torch.randn((BATCH, h, w, cin), generator=g, device=dev
                        ).bfloat16()
        wt = torch.randn((k, k, cin, cout), generator=g, device=dev)
        convs.append((x, wt, s))

    def run_convs(policy):
        for x, wt, s in convs:
            cnn.pconv(x, wt, s, policy)

    def run_convs_bf16():
        for x, wt, s in convs:
            top, bottom = cnn._same_pads(x.shape[1], wt.shape[0], s)
            left, right = cnn._same_pads(x.shape[2], wt.shape[1], s)
            xc = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                         (left, right, top, bottom))
            torch.nn.functional.conv2d(
                xc, wt.bfloat16().permute(3, 2, 0, 1), stride=s)

    for name in ("fp32", "mpai"):
        pols = pose.POLICIES[name][:2]
        params = cnn.ursonet_init(torch.Generator(device=dev).manual_seed(0),
                                  cfg, dev)
        state = {"p": params, "opt": adamw.init(params)}

        def step():
            state["p"], state["opt"], _ = pose.train_step(
                state["p"], state["opt"], *args, cfg, pols, tc)

        for _ in range(3):
            step()

        def forward():
            with torch.no_grad():
                loc, q = cnn.ursonet_apply(state["p"], cfg, args[0], *pols)
                return cnn.pose_loss(loc, q, args[1], args[2])

        p, opt0 = state["p"], state["opt"]
        ones = tree_map(torch.ones_like, p)

        def update():
            adamw.apply_updates(p, ones, opt0, tc)

        def data():
            pose_batch(BATCH, 1, image_hw=cfg.image_hw, device=dev)

        row = {"condition": name, "config": cfg.name, "batch": BATCH,
               "card": card, "bound_ms": bound,
               "step_ms": wall_ms(step),
               "enqueue_ms": wall_ms(step, sync=False),
               "forward_ms": wall_ms(forward),
               "forward_enqueue_ms": wall_ms(forward, sync=False),
               "forward_device_ms": graph_ms(forward),
               "adamw_ms": wall_ms(update),
               "adamw_device_ms": graph_ms(update),
               "data_ms": wall_ms(data), "data_device_ms": graph_ms(data),
               "convs_f32_device_ms": graph_ms(lambda: run_convs(P.bf16())),
               "convs_policy_device_ms": graph_ms(
                   lambda: run_convs(pols[0])),
               "convs_bf16_device_ms": graph_ms(run_convs_bf16),
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
