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


DONATE_BLOCK = 2 ** 26       # elements updated at once in place


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


def global_norm(grads) -> torch.Tensor:
    """The leaves' squared sums added in ``tree_leaves`` order, rooted."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that clips a tree of global norm ``gnorm`` to
    ``max_norm``."""
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    # widened first: the reference's bf16 leaf times a 0-dim f32 array
    # promotes to f32, and torch would keep bf16
    return tree_map(lambda g: g.float() * scale, grads), gnorm


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, tc: TrainConfig,
                  donate: bool = False, gnorm=None
                  ) -> Tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step: returns (new params, new state, the global norm of
    ``grads`` before clipping).  Each leaf's gradient is clipped as it is
    used, so no clipped copy of the whole tree is made.  With ``donate``
    the results are written into ``params`` and ``state``'s moments, which
    are returned (the reference's ``Trainer`` donates its state to the
    jitted step): the step then holds one state and its gradients, not
    two states.  ``gnorm``, where given, is the global norm of the whole
    gradient of which ``grads`` are parts (a rank's slices on a mesh)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, tc.grad_clip)
    count = state.count + 1
    lr = cosine_lr(tc, count)
    t = count.float()
    # float32 powers of float32 bases, made on the device (no host copy)
    bc1 = 1 - torch.pow(torch.full_like(t, tc.b1), t)
    bc2 = 1 - torch.pow(torch.full_like(t, tc.b2), t)

    def upd(p, g, m, v, decay: bool):
        g = g.float() * scale            # as clip_by_global_norm
        mf = _fma(tc.b1, m.float(), (1 - tc.b1) * g)
        vf = _fma(tc.b2, v.float(), (1 - tc.b2) * torch.square(g))
        mhat = mf / bc1
        vhat = vf / bc2
        step = mhat / (torch.sqrt(vhat) + 1e-8)
        if decay:
            step = _fma(tc.weight_decay, p.float(), step)
        return (p.double() - lr.double() * step.double()).float(), mf, vf

    def leaf(p, g, m, v):
        decay = p.ndim >= 2
        if not donate:
            new, mf, vf = upd(p, g, m, v, decay)
            return new.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)
        # in place, a block of rows at a time: the float64 temporaries of a
        # stacked leaf (all layers' weights) stay small; elementwise, so the
        # bits are those of the whole leaf at once
        rows = max(1, DONATE_BLOCK // max(1, p[0].numel())) if p.ndim else 1
        for sl in ((...,) if p.ndim == 0 else
                   (slice(i, i + rows) for i in range(0, p.shape[0], rows))):
            new, mf, vf = upd(p[sl], g[sl], m[sl], v[sl], decay)
            p[sl].copy_(new)
            m[sl].copy_(mf)
            v[sl].copy_(vf)
        return p, m, v

    out = tree_map(leaf, params, grads, state.mu, state.nu)
    # ``out`` has params' shape with a (param, mu, nu) tuple at each leaf
    pick = lambda i: tree_map(lambda _, t3: t3[i], params, out)
    return pick(0), AdamWState(pick(1), pick(2), count), gnorm
