"""AdamW with a cosine schedule and global-norm clipping (the port of
``repro.optim.adamw``).

Functions on parameter trees under ``torch.no_grad()``, written as the
reference writes them rather than through ``torch.optim.AdamW``, so the
arithmetic matches step for step: the bias corrections are float32 powers
of a float32 base, weight decay applies only to leaves with ``ndim >= 2``,
the global norm adds the leaves' squared sums in
``jax.tree_util.tree_leaves`` order (``tree_leaves``), and the moment
updates and the schedule round as XLA's fused CPU code does (``_fma``,
``_inv``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor           # [] int32, on the parameters' device


def init(params, dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=dtype)
    device = tree_leaves(params)[0].device
    return AdamWState(tree_map(zeros, params), tree_map(zeros, params),
                      torch.zeros((), dtype=torch.int32, device=device))


def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` rounded once to float32, as XLA's CPU code fuses the
    reference's moment updates (the product is exact in float64)."""
    return (x.double() * float(np.float32(a)) + y.double()).float()


def _inv(d: int) -> float:
    return float(np.float32(1.0) / np.float32(d))


def cosine_lr(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, then a cosine to 0 at
    ``total_steps``; ``step`` an int tensor, the result float32."""
    step = step.float()
    # XLA folds the reference's divisions by constants into products with
    # their float32 reciprocals
    warm = torch.clamp_max(step * _inv(max(tc.warmup_steps, 1)), 1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       * _inv(max(tc.total_steps - tc.warmup_steps, 1)), 0, 1)
    return tc.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi * prog))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), gnorm


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState,
                  tc: TrainConfig) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step: returns (new params, new state, the global norm of
    ``grads`` before clipping)."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    count = state.count + 1
    lr = cosine_lr(tc, count)
    t = count.float()
    # float32 powers of float32 bases, made on the device (no host copy)
    bc1 = 1 - torch.pow(torch.full_like(t, tc.b1), t)
    bc2 = 1 - torch.pow(torch.full_like(t, tc.b2), t)

    def upd(p, g, m, v):
        g = g.float()
        st_dtype = m.dtype                       # optimizer-state dtype
        mf = _fma(tc.b1, m.float(), (1 - tc.b1) * g)
        vf = _fma(tc.b2, v.float(), (1 - tc.b2) * torch.square(g))
        mhat = mf / bc1
        vhat = vf / bc2
        step = mhat / (torch.sqrt(vhat) + 1e-8)
        if p.ndim >= 2:
            step = _fma(tc.weight_decay, p.float(), step)
        new = (p.double() - lr.double() * step.double()).float()
        return new.to(p.dtype), mf.to(st_dtype), vf.to(st_dtype)

    out = tree_map(upd, params, grads, state.mu, state.nu)
    # ``out`` has params' shape with a (param, mu, nu) tuple at each leaf
    pick = lambda i: tree_map(lambda _, t3: t3[i], params, out)
    return pick(0), AdamWState(pick(1), pick(2), count), gnorm
