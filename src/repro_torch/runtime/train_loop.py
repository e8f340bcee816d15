"""The LM training loop (the port of ``repro.runtime.train_loop``): a
step with microbatch gradient accumulation and AdamW, checkpointing and
fault-tolerant restart hooks.

The reference jits one sharded step over a device mesh; the port runs the
same step eagerly on one device (a mesh of more devices is ROADMAP.md's
queue 1 item 7, distributed execution).  Partition-aware QAT is just a
plan argument — the same loop trains baseline and MPAI variants.  On the
card the step differentiates through the backward kernels of flash
attention, wkv and the selective scan, none of which uses atomics, so a
replayed step repeats bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: torch.Tensor            # [] int32, on the parameters' device


def _grad(loss: torch.Tensor, params) -> Any:
    """d loss / d params as a tree of ``params``' shape."""
    leaves = tree_leaves(params)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return tree_map(lambda p: grads[id(p)], params)


def make_step_fn(cfg: ModelConfig, tc: TrainConfig,
                 plan: Optional[PartitionPlan], tp: int,
                 donate: bool = False):
    """(state, batch) -> (state, metrics); grad-accum aware.  ``batch``
    holds ``tokens`` and ``labels`` [B, S] (and ``frontend_embeds`` for a
    frontend arch); ``cfg.grad_accum`` microbatches of B / grad_accum rows
    each are summed in ``tc.accum_dtype`` and averaged.  With ``donate``
    the step updates the state's tensors in place (``adamw.apply_updates``),
    as the reference's ``Trainer`` donates its state to the jitted step."""

    def loss(params, tokens, labels, fe):
        return T.loss_fn(params, cfg, tokens, labels, plan, tp,
                         frontend_embeds=fe)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state.params)
        fe = batch.get("frontend_embeds")
        ga = cfg.grad_accum
        if ga > 1:
            mb = batch["tokens"].shape[0] // ga
            acc_dt = getattr(torch, tc.accum_dtype)
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                  device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for m in range(ga):
                rows = slice(m * mb, (m + 1) * mb)
                l = loss(params, batch["tokens"][rows],
                         batch["labels"][rows],
                         None if fe is None else fe[rows])
                g = _grad(l, params)
                gsum = tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
                lsum = lsum + l.detach()
            # XLA turns the reference's division by the constant into a
            # product with its float32 reciprocal
            inv = float(np.float32(1.0) / np.float32(ga))
            grads = tree_map(lambda g_: g_ * inv, gsum)
            l = lsum * inv
        else:
            l = loss(params, batch["tokens"], batch["labels"], fe)
            grads = _grad(l, params)
            l = l.detach()
        new, opt, gnorm = adamw.apply_updates(state.params, grads,
                                              state.opt, tc, donate)
        return (TrainState(new, opt, state.step + 1),
                {"loss": l, "grad_norm": gnorm})
    return step


class Trainer:
    """Trains ``cfg`` on ``device`` (the card unless the caller asks for
    the CPU).  ``mesh_cfg`` must be one device."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_cfg: MeshConfig, tc: TrainConfig,
                 plan: Optional[PartitionPlan] = None, device="cuda"):
        if mesh_cfg.num_devices != 1:
            raise NotImplementedError(
                f"mesh {mesh_cfg.shape}: the port trains on one device; "
                f"sharded training is ROADMAP.md queue 1 item 7 "
                f"(distributed and staged execution)")
        self.cfg, self.shape, self.tc, self.plan = cfg, shape, tc, plan
        self.mesh_cfg = mesh_cfg
        self.device = torch.device(device)
        self.tp = mesh_cfg.tp
        # the state is handed over each step, as the reference's jit
        # donates it: a 3 B-parameter state and its update fit one card
        self.step_fn = make_step_fn(cfg, tc, plan, self.tp, donate=True)

    def _init_state(self, device) -> TrainState:
        """The port's own seeded init (``T.model_init`` from
        ``tc.seed``); its values are not the reference's."""
        gen = torch.Generator(device=device if device.type != "meta"
                              else "cpu").manual_seed(self.tc.seed)
        params = T.model_init(self.cfg, gen, device, self.tp)
        return TrainState(params,
                          adamw.init(params, getattr(torch,
                                                     self.tc.opt_dtype)),
                          torch.zeros((), dtype=torch.int32, device=device))

    def init_state(self) -> TrainState:
        return self._init_state(self.device)

    def state_like(self) -> TrainState:
        """The state's structure, shapes and dtypes as ``meta`` tensors
        (what a checkpoint restores into)."""
        return self._init_state(torch.device("meta"))

    def run(self, state: TrainState, data_fn, num_steps: int,
            ckpt=None, log_every: int = 10, on_step=None):
        """data_fn(step) -> batch dict.  Returns (state, history)."""
        history = []
        start = int(state.step)
        for s in range(start, start + num_steps):
            batch = data_fn(s)
            state, metrics = self.step_fn(state, batch)
            if on_step is not None:
                on_step(s, state, metrics)
            if (s + 1) % log_every == 0 or s == start:
                history.append({"step": s + 1,
                                "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])})
            if ckpt is not None and (s + 1) % self.tc.checkpoint_every == 0:
                ckpt.save(s + 1, state)
        return state, history
