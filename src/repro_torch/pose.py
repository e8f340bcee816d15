"""UrsoNet training and evaluation on the synthetic pose task (the port of
``repro.pose``): Table I's four software conditions, end to end.

The conditions map to (backbone, head) policies:
  fp32 baseline : (bf16 raw,  fp32 raw)
  int8 PTQ      : (int8 quant, int8 quant)     -- trained fp32, served int8
  int8 QAT      : (int8 fake -> int8 quant, same)
  MPAI          : (int8 fake -> int8 quant, bf16 raw)  -- partition-aware

Training takes its gradient with ``torch.autograd`` (fake quantization
passes it straight through) and steps ``optim.adamw``; serving a quant
head runs its three FC products through the int8 GEMM kernel on the card.
Every entry point runs on ``device`` (the card unless the caller asks for
the CPU).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.data.pipeline import pose_batch
from repro_torch.models.cnn import (UrsoNetConfig, pose_loss, pose_metrics,
                                    ursonet_apply, ursonet_init)
from repro_torch.optim import adamw


def train_step(params, opt: adamw.AdamWState, images: torch.Tensor,
               loc: torch.Tensor, quat: torch.Tensor, cfg: UrsoNetConfig,
               policies: Tuple[PrecisionPolicy, PrecisionPolicy],
               tc: TrainConfig):
    """One step: the loss and its gradient under the (backbone, head)
    training ``policies``, then AdamW.  Returns (params, opt, loss), the
    loss a 0-d tensor taken before the update."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    pl, pq = ursonet_apply(params, cfg, images, *policies)
    loss = pose_loss(pl, pq, loc, quat)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    params = tree_map(lambda p: p.detach(), params)
    params, opt, _ = adamw.apply_updates(params, grads, opt, tc)
    return params, opt, loss.detach()


def train_ursonet(cfg: UrsoNetConfig,
                  backbone_policy: PrecisionPolicy,
                  head_policy: PrecisionPolicy,
                  steps: int = 200, batch: int = 16, lr: float = 3e-3,
                  seed: int = 0, device="cuda"):
    """Train from the port's seeded init; returns (params, history), the
    history ``(step, loss)`` every 25 steps and at the last."""
    tc = TrainConfig(learning_rate=lr, warmup_steps=10, total_steps=steps,
                     weight_decay=0.0, grad_clip=1.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ursonet_init(gen, cfg, device)
    opt = adamw.init(params)
    history = []
    for s in range(steps):
        b = pose_batch(batch, s, seed=seed, image_hw=cfg.image_hw,
                       device=device)
        params, opt, loss = train_step(params, opt, b["images"], b["loc"],
                                       b["quat"], cfg,
                                       (backbone_policy, head_policy), tc)
        if s % 25 == 0 or s == steps - 1:
            history.append((s, float(loss)))
    return params, history


@torch.no_grad()
def eval_ursonet(params, cfg: UrsoNetConfig,
                 backbone_policy: PrecisionPolicy,
                 head_policy: PrecisionPolicy,
                 batches: int = 8, batch: int = 16, seed: int = 1000,
                 device="cuda") -> Tuple[float, float]:
    """Returns (LOCE meters, ORIE degrees) on held-out batches."""
    loces, ories = [], []
    for s in range(batches):
        b = pose_batch(batch, 10_000 + s, seed=seed, image_hw=cfg.image_hw,
                       device=device)
        loc, quat = ursonet_apply(params, cfg, b["images"], backbone_policy,
                                  head_policy)
        l, o = pose_metrics(loc, quat, b["loc"], b["quat"])
        loces.append(float(l))
        ories.append(float(o))
    return sum(loces) / len(loces), sum(ories) / len(ories)


POLICIES: Dict[str, Tuple[PrecisionPolicy, PrecisionPolicy,
                          PrecisionPolicy, PrecisionPolicy]] = {
    # name: (train_backbone, train_head, serve_backbone, serve_head)
    "fp32": (PrecisionPolicy.bf16(), PrecisionPolicy.fp32(),
             PrecisionPolicy.bf16(), PrecisionPolicy.fp32()),
    "int8_ptq": (PrecisionPolicy.bf16(), PrecisionPolicy.fp32(),
                 PrecisionPolicy.int8(), PrecisionPolicy.int8()),
    "int8_qat": (PrecisionPolicy.int8_qat(), PrecisionPolicy.int8_qat(),
                 PrecisionPolicy.int8(), PrecisionPolicy.int8()),
    "mpai": (PrecisionPolicy.int8_qat(), PrecisionPolicy.bf16(),
             PrecisionPolicy.int8(), PrecisionPolicy.bf16()),
}


def run_condition(name: str, cfg: UrsoNetConfig, steps: int = 200,
                  batch: int = 16, seed: int = 0, device="cuda"):
    tb, th, sb, sh = POLICIES[name]
    params, hist = train_ursonet(cfg, tb, th, steps=steps, batch=batch,
                                 seed=seed, device=device)
    loce, orie = eval_ursonet(params, cfg, sb, sh, batch=batch,
                              device=device)
    return {"condition": name, "loce": loce, "orie": orie,
            "final_train_loss": hist[-1][1]}
