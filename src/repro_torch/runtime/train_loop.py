"""The LM training loop (the port of ``repro.runtime.train_loop``): a
step with microbatch gradient accumulation and AdamW, on one device or on
a mesh of ``torch.distributed`` ranks, checkpointing and fault-tolerant
restart hooks.

On one device (no process group) the step runs eagerly, as the
reference's jitted step does without a mesh.  On a mesh (``build_mesh``;
one rank a device) the state is laid out as the reference's
``sharding.param_specs`` lays it out — each rank holds the slices that
``NamedSharding`` gives the device at its coordinate, AdamW's moments
with their parameters — and each step:

* keeps the rank's rows of the global batch (``sharding.data_specs``):
  its share of each global microbatch, so that microbatch m is the
  reference's rows ``[m * mb, (m + 1) * mb)`` across the ranks;
* gathers the parameters (an all-gather over each split dim's axes).
  Under ``sharding_mode == "tp"`` on a model axis of several ranks the
  leaves that ``sharding.head_parallel`` names (attention, dense and MoE
  MLPs, Mamba's and RWKV-6's mixers and channel mix, the embedding and
  the head) gather only their data-axis parts and keep the rank's
  model-axis part, Mamba's ``in_proj`` re-laid to the rank's channels of
  its two halves (an all-to-all in ``TreeSharding.unshard``; its gradient
  goes back the same way in ``TreeSharding.shard``); the others (norms,
  the router, the token shifts' mixes) are gathered whole.  A stacked
  ``layers`` leaf that those gathers split (FSDP: ``fsdp=True``, or
  ``sharding_mode == "fsdp"``) is not gathered here: the step keeps the
  rank's part (``in_proj``'s re-laid) and the model gathers one
  super-block at a time inside the layer gather
  (``sharding.BlockGather``, ``core/collectives.layer_gather``), in the
  forward and in remat's recompute; the block's gradient is all-reduced
  over the batch's ranks in the backward and cut to the rank's slice,
  so the microbatch accumulator holds slices, as the reference's
  sharded ``gsum`` does;
* runs the forward and backward on those rows inside the batch group of
  the ranks that split the batch and the model group of the model axis
  (``core/collectives.py``).  The batch group makes per-tensor activation
  scales take the global batch's absmax, and MoE routing choose its path
  on the global token count and take its load-balancing loss over the
  global batch, as the reference's jitted step does on the whole batch.
  The model group makes the head-parallel leaves compute as the
  reference's pjit step partitions them: column- and row-parallel
  projections with an all-reduce, head-local attention, the wkv and
  selective-scan kernels (and their backwards) on the rank's heads and
  channels, a vocab-parallel embedding, head and loss, expert-parallel
  MoE.  What stays replicated (the residual stream, norms, the router,
  the loss) is the same on every model rank, and so are the gradients of
  the replicated leaves;
* all-reduces each other gradient over the ranks that split the batch
  (an ``all_reduce`` then a slice, on gloo and NCCL alike) and divides
  every gradient by their count; the model axis needs no reduction;
* takes the global norm from each leaf's squared sum, a per-block leaf's
  all-reduced over its data-axis group and a head-parallel leaf's over
  the model group (whose gradient each rank holds a part of), added in
  ``tree_leaves`` order, then keeps the rank's slices;
* runs AdamW on the rank's slices, in place, clipped by that norm.

A collective over one rank is an identity and is skipped, so on a mesh of
one device the step does the one-device step's arithmetic, bit for bit;
a mesh whose data axes split no layer leaf runs no layer gather.  Where
they do, the sums over ranks and microbatches come in another order
than the whole-stack step's (each microbatch's block gradient reduced,
then accumulated): with one microbatch on two batch ranks the slices are
the same bits.
Under ``sharding_mode == "fsdp"`` the model axis splits the batch too
and compute stays replicated along it.

Partition-aware QAT is just a plan argument — the same loop trains
baseline and MPAI variants.  On the card the step differentiates through
the backward kernels of flash attention, wkv and the selective scan, none
of which uses atomics, so a replayed step repeats bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import sharding as shard
from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import collectives
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


def build_mesh(mesh_cfg: MeshConfig):
    """A ``DeviceMesh`` of ``mesh_cfg`` over the initialised process group
    (whose world must be ``mesh_cfg.num_devices`` ranks)."""
    from repro_torch.launch.mesh import make_mesh_from_config
    return make_mesh_from_config(mesh_cfg)


def _on_mesh(mesh_cfg: MeshConfig) -> bool:
    """Whether a ``Trainer`` of ``mesh_cfg`` trains on a mesh of ranks: a
    mesh of several devices always (``build_mesh`` refuses a world of
    another size), one device when the initialised process group is that
    one rank.  One device alone, or inside a larger world, trains as one
    device."""
    import torch.distributed as dist
    if mesh_cfg.num_devices > 1:
        return True
    return dist.is_initialized() and dist.get_world_size() == 1


def make_grad_fn(cfg: ModelConfig, tc: TrainConfig,
                 plan: Optional[PartitionPlan], tp: int):
    """(params, batch) -> (loss, grads); grad-accum aware.  ``batch``
    holds ``tokens`` and ``labels`` [B, S] (and ``frontend_embeds`` for a
    frontend arch); ``cfg.grad_accum`` microbatches of B / grad_accum rows
    each are summed in ``tc.accum_dtype`` and averaged."""

    def loss(params, tokens, labels, fe):
        return T.loss_fn(params, cfg, tokens, labels, plan, tp,
                         frontend_embeds=fe)

    def grads_of(params, batch: Dict[str, torch.Tensor]):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
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
            return lsum * inv, tree_map(lambda g_: g_ * inv, gsum)
        l = loss(params, batch["tokens"], batch["labels"], fe)
        return l.detach(), _grad(l, params)
    return grads_of


def make_step_fn(cfg: ModelConfig, tc: TrainConfig,
                 plan: Optional[PartitionPlan], tp: int,
                 donate: bool = False):
    """(state, batch) -> (state, metrics) on one device (``make_grad_fn``,
    then AdamW).  With ``donate`` the step updates the state's tensors in
    place (``adamw.apply_updates``), as the reference's ``Trainer``
    donates its state to the jitted step."""
    grads_of = make_grad_fn(cfg, tc, plan, tp)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        l, grads = grads_of(state.params, batch)
        new, opt, gnorm = adamw.apply_updates(state.params, grads,
                                              state.opt, tc, donate)
        return (TrainState(new, opt, state.step + 1),
                {"loss": l, "grad_norm": gnorm})
    return step


class Trainer:
    """Trains ``cfg`` on ``device`` (the card unless the caller asks for
    the CPU): on a mesh of ranks (``build_mesh(mesh_cfg)``, one rank a
    device, each rank on its own ``device``) where ``_on_mesh(mesh_cfg)``,
    else on that device alone."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_cfg: MeshConfig, tc: TrainConfig,
                 plan: Optional[PartitionPlan] = None, device="cuda"):
        self.cfg, self.shape, self.tc, self.plan = cfg, shape, tc, plan
        self.mesh_cfg = mesh_cfg
        self.device = torch.device(device)
        self.tp = mesh_cfg.tp
        self.mesh = build_mesh(mesh_cfg) if _on_mesh(mesh_cfg) else None
        self.state_shardings = None
        if self.mesh is None:
            # the state is handed over each step, as the reference's jit
            # donates it: a 3 B-parameter state and its update fit one card
            self.step_fn = make_step_fn(cfg, tc, plan, self.tp, donate=True)
        else:
            self._place(self.mesh)

    # ------------------------------------------------------------------
    def _place(self, mesh) -> None:
        cfg, mesh_cfg = self.cfg, self.mesh_cfg
        pl = shard.Placement(mesh_cfg, mesh)
        like = self.state_like()
        self.param_specs = shard.param_specs(cfg, like.params, mesh_cfg)
        self.state_specs = TrainState(
            self.param_specs,
            adamw.AdamWState(self.param_specs, self.param_specs, shard.P()),
            shard.P())
        self.data_specs = shard.data_specs(cfg, self.shape, mesh_cfg)
        self.state_shardings = shard.TreeSharding(pl, self.state_specs, like)
        self.param_shardings = shard.TreeSharding(pl, self.param_specs,
                                                  like.params)
        self.placement = pl
        specs = tree_leaves(self.param_specs)
        shapes = [tuple(t.shape) for t in tree_leaves(like.params)]
        uneven = [(s, sp) for s, sp in zip(shapes, specs)
                  if shard.uneven_dims(sp, s, mesh_cfg)]
        if uneven:
            raise ValueError(f"mesh {mesh_cfg.shape}: parameters that do "
                             f"not split evenly: {uneven[:4]}")
        # the leaves computed on the rank's model-axis part, or None where
        # the model axis computes replicated
        self.head_parallel = shard.head_parallel(cfg, like.params, mesh_cfg)
        tok = self.data_specs["tokens"]
        self.batch_axes = shard.dim_axes(tok, 1)[0]
        self.batch_ranks = pl.group_size(self.batch_axes)
        self.rows = self._batch_rows(tok)
        # every group of more than one rank the step uses, made once by
        # every rank in one order (``dist.new_group`` is collective); a
        # collective over one rank is skipped
        used = {self.batch_axes, (shard.MODEL,)}
        for s, sp in zip(shapes, specs):
            used.update(shard.dim_axes(sp, len(s)))
        for axes in sorted((a for a in used if pl.group_size(a) > 1),
                           key=lambda a: (len(a), a)):
            pl.group(axes)
        # the stacked leaves a data axis splits, gathered a super-block at
        # a time inside the step (None: every leaf is gathered whole)
        self.blocks = self.param_shardings.block_gather(self.head_parallel)
        self._grads_of = make_grad_fn(cfg, self.tc, self.plan, self.tp)
        self.step_fn = self._sharded_step

    def _batch_rows(self, tok) -> slice:
        """The rank's rows of each global microbatch (its ``shard_slices``
        part of ``global_batch / grad_accum`` rows); the step keeps them
        microbatch by microbatch, in order, so that ``make_grad_fn``'s
        split of the rank's rows gives back its part of each."""
        ga, gb = self.cfg.grad_accum, self.shape.global_batch
        mb = gb // ga
        if gb % ga or mb % self.batch_ranks:
            raise ValueError(
                f"mesh {self.mesh_cfg.shape}: a global batch of {gb} in "
                f"{ga} microbatches does not split evenly over the "
                f"{self.batch_ranks} ranks of {self.batch_axes}")
        return shard.shard_slices(tok, (mb, 1), self.mesh_cfg,
                                  self.placement.coord)[0]

    def _sharded_step(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        import torch.distributed as dist
        pl, hp, bg = self.placement, self.head_parallel, self.blocks
        blocks = None if bg is None else bg.leaves
        ga = self.cfg.grad_accum
        rows = {k: v.unflatten(0, (ga, -1))[:, self.rows].flatten(0, 1)
                for k, v in batch.items()}
        full = self.param_shardings.unshard(state.params, keep_model=hp,
                                            blocks=blocks)
        group = pl.group(self.batch_axes) if self.batch_ranks > 1 else None
        mranks = 1 if hp is None else pl.group_size((shard.MODEL,))
        mgroup = pl.group((shard.MODEL,)) if mranks > 1 else None
        with collectives.batch_group(group, self.batch_ranks), \
                collectives.model_group(mgroup, mranks,
                                        pl.coord.get(shard.MODEL, 0)), \
                collectives.layer_gather(bg):
            l, grads = self._grads_of(full, rows)
        del full
        if group is not None:

            def mean(t, reduced=False):
                # a per-block leaf's slices were reduced in the backward
                if not reduced:
                    dist.all_reduce(t, group=group)
                return t.div_(self.batch_ranks)
            l = mean(l.clone())
            grads = (tree_map(mean, grads) if bg is None
                     else tree_map(mean, grads, blocks))
        gnorm = self._global_norm(grads, mgroup)
        grads = self.param_shardings.shard(grads, keep_model=hp,
                                           blocks=blocks)
        new, opt, gnorm = adamw.apply_updates(
            state.params, grads, state.opt, self.tc, donate=True, gnorm=gnorm)
        return (TrainState(new, opt, state.step + 1),
                {"loss": l, "grad_norm": gnorm})

    def _global_norm(self, grads, mgroup) -> torch.Tensor:
        """The global norm of the step's gradient: each leaf's squared sum,
        a per-block leaf's (the rank's slices) all-reduced over the group
        of each axis its gathers act on, then a head-parallel leaf's over
        the model group (one call a group), added in ``tree_leaves``
        order, as ``adamw.global_norm``."""
        leaves = tree_leaves(grads)
        sq = [torch.sum(torch.square(g.float())) for g in leaves]
        by_group = {}
        if self.blocks is not None:
            for i, p in enumerate(tree_leaves(self.blocks.plans)):
                for axes in p.axes:
                    by_group.setdefault(axes, []).append(i)
        for axes in sorted(by_group):
            self._sum_parts(sq, by_group[axes], self.placement.group(axes))
        if mgroup is not None:
            self._sum_parts(sq, [i for i, (h, sp, g) in enumerate(zip(
                tree_leaves(self.head_parallel), tree_leaves(self.param_specs),
                leaves)) if h and any(shard.MODEL in ax
                                      for ax in shard.dim_axes(sp, g.ndim))],
                mgroup)
        return torch.sqrt(sum(sq))

    @staticmethod
    def _sum_parts(sq: list, idx: list, group) -> None:
        """``sq[i]`` for ``i`` in ``idx`` summed over ``group``'s ranks, in
        one all-reduce."""
        if idx:
            import torch.distributed as dist
            parts = torch.stack([sq[i] for i in idx])
            dist.all_reduce(parts, group=group)
            for j, i in enumerate(idx):
                sq[i] = parts[j]

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
        """The state from ``tc.seed``; on a mesh the whole tree is made
        and the rank's parts kept, so one seed gives one model on every
        mesh."""
        state = self._init_state(self.device)
        if self.state_shardings is None:
            return state
        return self.state_shardings.shard(state)

    def state_like(self) -> TrainState:
        """The state's structure, shapes and dtypes as ``meta`` tensors
        (what a checkpoint restores into; the whole shapes on a mesh)."""
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
                ckpt.save(s + 1, state, shardings=self.state_shardings)
        return state, history
