"""Dry run of the production mesh: trace every (arch x shape) cell as one
rank of a 256- or 512-rank world runs it, and report per-rank memory,
FLOPs, bytes, collective bytes and a roofline on H100 cards (the port of
``repro.launch.dryrun``).

It touches no device.  The world is a ``"fake"`` ``torch.distributed``
process group (``make_production_mesh`` over it), whose collectives move
nothing, and rank 0's step runs under ``FakeTensorMode``: every tensor
has a shape, a dtype and no storage.  This is the counterpart of the
reference faking 512 host devices and compiling each cell.

What runs is the port's one mesh execution, the mesh ``Trainer``'s:

* train cells run ``Trainer._sharded_step`` on a ``TrainState`` of the
  rank's parts (``sharding.param_specs``), built from ``specs.
  param_structs`` without ``init_state``: it gathers the parameters'
  data-axis parts (the head-parallel leaves, ``sharding.head_parallel``,
  keep their model-axis part, Mamba's ``in_proj`` re-laid by an
  all-to-all), a stacked ``layers`` leaf's one super-block at a time as
  the forward, remat's recompute and the backward reach it
  (``sharding.BlockGather``: its gradient all-reduced there and cut to
  the rank's slice, the microbatch accumulator holding slices), runs
  forward and backward on the rank's rows of the batch
  inside the batch group and the model group (``core/collectives.py``:
  per-tensor activation scales and MoE routing over the global batch;
  column- and row-parallel projections, head-local attention, the
  recurrent mixers on the rank's heads and channels, a vocab-parallel
  embedding, head and loss, expert-parallel MoE), all-reduces the
  gradients over the batch's ranks and runs AdamW on the rank's slices;
* prefill and decode cells lay the parameters out the same way (int8
  structs under ``--plan mpai``, bf16 otherwise) and the cache by
  ``sharding.cache_specs``, gather the same parts, the stacked layers'
  a super-block at a time (the cache keeps the rank's kv heads, RWKV-6
  state heads and Mamba channels) and run
  ``T.forward`` / ``T.decode_step`` on the rank's rows inside the same
  two groups (under ``--plan mpai`` the scales'
  all-reduces; an MoE layer's dispatch path on the global token count,
  and its load-balancing sums, which XLA drops from the reference's
  serving cells as unused).

Under ``sharding_mode == "fsdp"``, or on a model axis of one rank, the
model axis computes replicated.  Every row says so (``"execution"``;
``EXECUTION`` where a data axis splits the stacked layers, so they are
gathered a super-block at a time, ``EXECUTION_WHOLE`` where none does).
A per-block cell makes one all-gather a split leaf, block and pass (the
forward and each remat recompute) and one all-reduce of its gradient a
block and microbatch, where a whole-stack step made one a leaf.  A
tensor-parallel all-reduce is counted like any collective, on the link
``roofline.link_of`` gives its ranks: on 16 x 16 the 16-rank model axis
spans two 8-card nodes.

While a cell is traced each front door of ``kernels/ops.py`` is a
stand-in that allocates what the kernel's wrapper allocates on the card
(outputs, flash attention's ``lse``, the recurrent kernels' checkpoints,
the backward's partials) and adds the kernel's ``roofline.kernel_work``:
the plain versions would count the whole S^2 of causal attention and walk
the recurrences step by step in Python.

Per rank, each cell reports: ``argument_size_in_bytes`` (the parts of the
state, batch and cache the rank holds), ``temp_size_in_bytes`` (the peak
of live bytes over the step, less the arguments), ``flops``
(``FlopCounterMode`` plus the kernels' work), ``hlo_bytes`` (what the
GEMMs and kernels read and write), the collectives' bytes by kind (the
operands of the ``torch.distributed`` calls the step makes), the roofline
row and ``fits_80gb``.

The reference's ``probe_costs`` has no counterpart: it undoes XLA's
counting a scanned layer once, and the trace here unrolls every layer.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--plan mpai]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import roofline
from repro_torch import sharding as shard
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import (MeshConfig, ModelConfig, ShapeConfig,
                                      TrainConfig)
from repro_torch.core import collectives, qat
from repro_torch.core.partition import PartitionPlan
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels import ops as kops
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (make_mesh_from_config,
                                     make_production_mesh,
                                     production_mesh_config)
from repro_torch.models import transformer as T
from repro_torch.runtime.train_loop import Trainer

# a row's execution: where a data axis splits the stacked layers, their
# parts are gathered a super-block at a time (``sharding.BlockGather``)
EXECUTION_WHOLE = ("head-parallel compute on the model axis (attention, "
                   "MLPs, MoE, Mamba and RWKV-6 mixers); data-axis parts "
                   "gathered")
EXECUTION = (EXECUTION_WHOLE + " one super-block at a time (an all-gather "
             "a split leaf, block and pass)")
CARD_BYTES = 80e9            # an H100 80GB's memory, as fits_80gb reads it
SMS = 132                    # H100 SXM5 streaming multiprocessors


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks with this
    process as rank 0, for the length of the block: collectives return at
    once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world; a process "
                           "group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# What a traced step adds up
# ---------------------------------------------------------------------------
class Tally:
    """The kernels' work, the GEMMs' bytes and the collectives of one
    traced step."""

    def __init__(self):
        self.kernel_flops = 0.0
        self.kernel_bytes = 0
        self.kernel_calls = []            # (name, shapes) in launch order
        self.gemm_bytes = 0
        self.coll_bytes: Dict[str, float] = {}
        self.coll_counts: Dict[str, int] = {}
        self.link_bytes = {k: 0.0 for k in roofline.LINK_BW}
        # (kind, operand shape, the group's ranks) in call order
        self.coll_calls = []

    def kernel(self, name: str, **shapes) -> None:
        flops, nbytes, _ = roofline.kernel_work(name, **shapes)
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.kernel_calls.append((name, shapes))

    def collective(self, kind: str, operand_bytes: int, group,
                   shape=()) -> None:
        import torch.distributed as dist
        ranks = dist.get_process_group_ranks(group) if group is not None \
            else list(range(dist.get_world_size()))
        self.coll_calls.append((kind, tuple(shape), tuple(ranks)))
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + operand_bytes
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.link_bytes[roofline.link_of(ranks)] += roofline.wire_bytes(
            kind, operand_bytes, len(ranks))


class _GemmBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds the bytes that each op ``FlopCounterMode`` counts (the GEMMs,
    convolutions and attention products) reads and writes."""

    def __init__(self, tally: Tally, ops):
        super().__init__()
        self.tally, self.ops = tally, ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.ops:
            self.tally.gemm_bytes += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs or {}, out))
                if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def counted_collectives(tally: Tally):
    """The collectives a step makes (``torch.distributed.all_gather``,
    ``all_reduce`` and ``all_to_all_single``), counted into ``tally`` by
    their operands (an all-gather's input part, an all-reduce's tensor, an
    all-to-all's input), for the length of the block."""
    import torch.distributed as dist

    def all_gather(out, t, group=None, async_op=False):
        tally.collective("all-gather", _nbytes(t), group, t.shape)
        return real["all_gather"](out, t, group=group, async_op=async_op)

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        tally.collective("all-reduce", _nbytes(t), group, t.shape)
        return real["all_reduce"](t, op=op, group=group, async_op=async_op)

    def all_to_all_single(out, t, out_splits=None, in_splits=None,
                          group=None, async_op=False):
        tally.collective("all-to-all", _nbytes(t), group, t.shape)
        return real["all_to_all_single"](out, t, out_splits, in_splits,
                                         group=group, async_op=async_op)

    wrappers = {"all_gather": all_gather, "all_reduce": all_reduce,
                "all_to_all_single": all_to_all_single}
    real = {name: getattr(dist, name) for name in wrappers}
    for name, f in wrappers.items():
        setattr(dist, name, f)
    try:
        yield tally
    finally:
        for name, f in real.items():
            setattr(dist, name, f)


# ---------------------------------------------------------------------------
# The kernels' stand-ins
# ---------------------------------------------------------------------------
def _flash_shapes(q: torch.Tensor) -> Dict:
    b, s, kvp, gp, hd = q.shape
    return dict(b=b, s=s, kvp=kvp, gp=gp, hd=hd, itemsize=q.element_size())


def _standins(tally: Tally) -> Dict:
    """Each front door of ``kernels/ops.py`` as a stand-in: the wrapper's
    allocations on the card (``csrc`` wrappers in ``kernels/*.py``), no
    arithmetic, the kernel's work added to ``tally``."""
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels import wkv as wk

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            want = any(ctx.needs_input_grad)
            b, s, kvp, gp, _ = q.shape
            out = torch.empty_like(q.contiguous())
            lse = (torch.empty((b, kvp, s * gp), dtype=torch.float32)
                   if want else None)
            tally.kernel("flash_attention", **_flash_shapes(q))
            if want:
                ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.contiguous()
            grads = tuple(torch.empty_like(t) for t in (q, k, v))
            scratch = torch.empty_like(lse)
            tally.kernel("flash_attention_bwd", **_flash_shapes(q))
            del scratch
            return grads

    class WKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, w, u):
            ctx.set_materialize_grads(False)
            y, s_fin, ckpt = wkv_launch(r, checkpoints=True)
            ctx.save_for_backward(r, k, v, w, u, ckpt)
            return y, s_fin

        @staticmethod
        def backward(ctx, dy, ds_fin):
            r, k, v, w, u, ckpt = ctx.saved_tensors
            b, s, h, n = r.shape
            if dy is None:
                dy = torch.zeros(r.shape, dtype=torch.float32)
            dy = dy.float()
            grads = [torch.empty_like(r) for _ in range(4)]
            p = wk.bwd_plan(s, n)
            du_part = torch.empty((b, h, p.chunks, n), dtype=torch.float32)
            xs = torch.empty_like(ckpt) if p.split else None
            tally.kernel("wkv_bwd", b=b, s=s, h=h, n=n,
                         ds_fin=ds_fin is not None)
            del xs
            grads.append(du_part.sum((0, 2)))
            return tuple(g.to(t.dtype) for g, t in zip(grads,
                                                       (r, k, v, w, u)))

    def wkv_launch(r, checkpoints: bool):
        b, s, h, n = r.shape
        y = torch.empty_like(r)
        s_fin = torch.empty((b, h, n, n), dtype=torch.float32)
        ckpt = (torch.empty((b, h, -(-s // wk.CKPT_EVERY), n, n),
                            dtype=torch.float32) if checkpoints else None)
        tally.kernel("wkv", b=b, s=s, h=h, n=n)
        return y, s_fin, ckpt

    def wkv(r, k, v, w, u):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (r, k, v, w, u)):
            return WKV.apply(r, k, v, w, u)
        y, s_fin, _ = wkv_launch(r, checkpoints=False)
        return y, s_fin

    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, b, c, a, d):
            ctx.set_materialize_grads(False)
            y, h_fin, ckpt = scan_launch(x, a, checkpoints=True)
            ctx.save_for_backward(x, dt, b, c, a, d, ckpt)
            return y, h_fin

        @staticmethod
        def backward(ctx, dy, dh_fin):
            x, dt, b, c, a, d, ckpt = ctx.saved_tensors
            bsz, s, dim = x.shape
            n = a.shape[-1]
            if dy is None:
                dy = torch.zeros(x.shape, dtype=torch.float32)
            dy = dy.float()
            dx, ddt = torch.empty_like(x), torch.empty_like(x)
            p = ss.bwd_plan(bsz, s, dim, n, SMS)
            groups = p.chunks if p.split else 1
            blocks = ss.bwd_blocks(dim, n)
            db_part, dc_part = (torch.empty((blocks, bsz, s, n),
                                            dtype=torch.float32)
                                for _ in range(2))
            da_part = torch.empty((groups, bsz, dim, n), dtype=torch.float32)
            dd_part = torch.empty((groups, bsz, dim), dtype=torch.float32)
            xs = torch.empty_like(ckpt) if p.split else None
            tally.kernel("selective_scan_bwd", b=bsz, s=s, dim=dim, n=n,
                         dh_fin=dh_fin is not None)
            del xs
            grads = (dx, ddt, db_part.sum(0), dc_part.sum(0),
                     da_part.sum((0, 1)), dd_part.sum((0, 1)))
            return tuple(g.to(t.dtype) for g, t in zip(grads,
                                                       (x, dt, b, c, a, d)))

    def scan_launch(x, a, checkpoints: bool):
        bsz, s, dim = x.shape
        n = a.shape[-1]
        y = torch.empty_like(x)
        h_fin = torch.empty((bsz, dim, n), dtype=torch.float32)
        ckpt = (torch.empty((bsz, dim, -(-s // ss.CKPT_EVERY), n),
                            dtype=torch.float32) if checkpoints else None)
        tally.kernel("selective_scan", b=bsz, s=s, dim=dim, n=n)
        return y, h_fin, ckpt

    def selective_scan(x, dt, b, c, a, d):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, dt, b, c, a, d)):
            return Scan.apply(x, dt, b, c, a, d)
        y, h_fin, _ = scan_launch(x, a, checkpoints=False)
        return y, h_fin

    def int8_matmul(x, w):
        m, k = x.shape
        n = w.shape[1]
        tally.kernel("int8_matmul", m=m, k=k, n=n)
        return torch.empty((m, n), dtype=torch.int32)

    def rowwise_quant_into(k, v, k_q, v_q, k_scale, v_scale, slot=None):
        b, s, h, hd = k.shape
        tally.kernel("rowwise_quant_into", elements=k.numel(),
                     itemsize=k.element_size(),
                     written=b * min(s, k_q.shape[1]) * h, hd=hd)

    def paged_attention(q, k_pool, v_pool, block_table, lengths):
        # the lengths are data: count every table entry as a full page
        b, kvp, gp, hd = q.shape
        page, entries = k_pool.shape[1], block_table.numel()
        tally.kernel("paged_attention", b=b, kvp=kvp, gp=gp, hd=hd,
                     page=page, table=entries, blocks=entries,
                     tokens=entries * page)
        return torch.empty_like(q)

    return {"flash_attention": Flash.apply, "wkv": wkv,
            "selective_scan": selective_scan, "int8_matmul": int8_matmul,
            "rowwise_quant_into": rowwise_quant_into,
            "paged_attention": paged_attention}


@contextlib.contextmanager
def kernel_standins(tally: Tally):
    """The front doors of ``kernels/ops.py`` swapped for ``_standins`` for
    the length of the block."""
    swap = _standins(tally)
    real = {name: getattr(kops, name) for name in swap}
    for name, f in swap.items():
        setattr(kops, name, f)
    try:
        yield
    finally:
        for name, f in real.items():
            setattr(kops, name, f)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def _make_plan(cfg: ModelConfig, plan_name: str, kind: str):
    if plan_name == "bf16":
        return None
    if plan_name == "mpai":
        base = PartitionPlan.mpai(cfg.num_layers,
                                  split=max(1, cfg.num_layers
                                            - T.pattern_period(cfg)))
        return qat.train_plan(base) if kind == "train" else qat.serve_plan(base)
    raise ValueError(plan_name)


def _local(like: torch.Tensor, spec, mesh_cfg: MeshConfig, coord,
           device=None):
    return torch.empty(shard.local_shape(spec, like.shape, mesh_cfg, coord),
                       dtype=like.dtype, device=device)


# the cache leaves that hold a rank's heads or channels (``sharding.
# cache_specs`` splits them over the model axis)
_HEAD_LOCAL_CACHE = ("k", "v", "k_scale", "v_scale", "h", "conv", "s")


class _CacheLayout:
    """The decode cache as ``specs.cache_structs`` stacks it, its specs
    (``sharding.cache_specs``), the same specs with the batch entry whole
    (the rank keeps its rows and gathers its heads; with ``head_local`` it
    keeps its kv heads, state heads and channels too) and
    ``T.init_cache``'s structure, which ``T.decode_step`` takes
    (per-super-block lists for the recurrent sublayers)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_cfg: MeshConfig, tp: int, head_local: bool = False):
        self.structs = S.cache_structs(cfg, shape, tp)
        self.specs = shard.cache_specs(cfg, self.structs, shape, mesh_cfg)
        b_ax = shard.P(shard.batch_axes(shape.global_batch, mesh_cfg))[0]
        self.rows = shard._map_with_path(lambda path, sp: shard.P(*(
            None if e == b_ax and e is not None
            or head_local and shard._leaf_name(path) in _HEAD_LOCAL_CACHE
            else e for e in sp)), self.specs)
        self.like = T.init_cache(cfg, 1, 1, tp, device="meta")
        self.mesh_cfg = mesh_cfg

    def parts(self, coord, device=None):
        return tree_map(lambda t, sp: _local(t, sp, self.mesh_cfg, coord,
                                             device),
                        self.structs, self.specs)

    def gathered(self, parts, pl: shard.Placement):
        """The rows' cache, its heads gathered as ``self.rows`` says, in
        ``T.init_cache``'s structure."""
        whole = tree_map(lambda t, sp: shard.unshard(
            t, sp, _rows_shape(t, sp, self.mesh_cfg), self.mesh_cfg,
            pl.group), parts, self.rows)
        cache = {}
        for key, c in self.like.items():
            g = whole[key]
            cache[key] = ([type(c[0])(*(None if t is None else t[i]
                                        for t in g))
                           for i in range(len(c))]
                          if isinstance(c, list) else g)
        return cache


def _rows_shape(part: torch.Tensor, spec, mesh_cfg: MeshConfig):
    """The whole shape of ``part`` along the dims ``spec`` splits."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    out = []
    for dim, axes in zip(part.shape, shard.dim_axes(spec, part.ndim)):
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(dim * n)
    return tuple(out)


class Cell:
    """One (arch x shape x mesh) cell as rank 0 of the initialised world of
    ``mesh_cfg.num_devices`` ranks runs it: ``arguments`` are the rank's
    parts of what the step takes (state and batch; parameters and batch;
    parameters, tokens and cache), ``step`` runs the execution of the
    module docstring on them."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_cfg: MeshConfig, plan_name: str = "bf16",
                 tc: Optional[TrainConfig] = None, device_mesh=None):
        self.cfg, self.shape, self.mesh_cfg = cfg, shape, mesh_cfg
        self.tp = mesh_cfg.tp
        self.plan = _make_plan(cfg, plan_name, shape.kind)
        if shape.kind == "train":
            self.trainer = Trainer(cfg, shape, mesh_cfg, tc or TrainConfig(),
                                   plan=self.plan, device="cpu")
            self.placement = self.trainer.placement
            self.like = self.trainer.state_like()
            self.specs = self.trainer.state_specs
            self.blocks = self.trainer.blocks
            return
        self.placement = shard.Placement(
            mesh_cfg, device_mesh or make_mesh_from_config(mesh_cfg))
        if self.plan is not None and any(s.policy.mode == "quant"
                                         for s in self.plan.segments):
            self.like = S.param_structs_quantized(cfg, self.tp)
        else:
            self.like = S.param_structs(cfg, self.tp, torch.bfloat16)
        self.specs = shard.param_specs(cfg, self.like, mesh_cfg)
        self.params = shard.TreeSharding(self.placement, self.specs,
                                         self.like)
        # the model group the serving step enters, as the Trainer does
        self.head_parallel = shard.head_parallel(cfg, self.like, mesh_cfg)
        self.model_ranks = (1 if self.head_parallel is None else
                            self.placement.group_size((shard.MODEL,)))
        self.model_group = (self.placement.group((shard.MODEL,))
                            if self.model_ranks > 1 else None)
        # the layer gather the serving step enters, as the Trainer does
        self.blocks = self.params.block_gather(self.head_parallel)
        if shape.kind == "decode":
            self.cache = _CacheLayout(cfg, shape, mesh_cfg, self.tp,
                                      head_local=self.model_ranks > 1)
            b_ax = shard.P(shard.batch_axes(shape.global_batch, mesh_cfg))
        else:
            b_ax = shard.data_specs(cfg, shape, mesh_cfg)["tokens"]
        # the batch group the serving step enters; a train cell's is the
        # Trainer's own
        batch_axes = shard.dim_axes(b_ax, 1)[0]
        self.batch_ranks = self.placement.group_size(batch_axes)
        self.batch_group = (self.placement.group(batch_axes)
                            if self.batch_ranks > 1 else None)

    def arguments(self, device=None) -> tuple:
        """The rank's parts, made on ``device`` (fake ones under
        ``FakeTensorMode``)."""
        coord, mesh_cfg = self.placement.coord, self.mesh_cfg
        first = tree_map(lambda t, sp: _local(t, sp, mesh_cfg, coord, device),
                         self.like, self.specs)
        if self.shape.kind != "decode":
            specs = shard.data_specs(self.cfg, self.shape, mesh_cfg)
            batch = {k: _local(v, specs[k], mesh_cfg, coord, device)
                     for k, v in S.batch_specs(self.cfg, self.shape).items()}
            return first, batch
        b_ax = shard.batch_axes(self.shape.global_batch, mesh_cfg)
        tok = S.decode_specs(self.cfg, self.shape, self.tp)[0]["tokens"]
        return (first,
                _local(tok, shard.P(b_ax, None), mesh_cfg, coord, device),
                self.cache.parts(coord, device))

    def step(self, *args):
        """The step on the rank's parts; returns what it outputs."""
        if self.shape.kind == "train":
            return self.trainer._sharded_step(*args)
        with collectives.batch_group(self.batch_group, self.batch_ranks), \
                collectives.model_group(
                    self.model_group, self.model_ranks,
                    self.placement.coord.get(shard.MODEL, 0)), \
                collectives.layer_gather(self.blocks):
            return self._serve_step(*args)

    @property
    def execution(self) -> str:
        return EXECUTION_WHOLE if self.blocks is None else EXECUTION

    def _serve_step(self, *args):
        """Prefill or decode on the rank's rows."""
        cfg, plan, tp = self.cfg, self.plan, self.tp
        hp = self.head_parallel
        blocks = None if self.blocks is None else self.blocks.leaves
        if self.shape.kind == "prefill":
            params, batch = args
            full = self.params.unshard(params, keep_model=hp, blocks=blocks)
            return T.forward(full, cfg, batch["tokens"], plan, tp,
                             frontend_embeds=batch.get("frontend_embeds")
                             ).logits
        params, tokens, parts = args
        cache = self.cache.gathered(parts, self.placement)
        full = self.params.unshard(params, keep_model=hp, blocks=blocks)
        logits = T.decode_step(full, cfg, tokens, cache, plan, tp).logits
        # the reference donates the cache: the step's new cache is the
        # rank's parts, rewritten
        return logits, parts


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
               plan_name: str = "bf16", tc: Optional[TrainConfig] = None,
               device_mesh=None) -> Dict:
    """Trace rank 0's step of the cell in the initialised (fake) world of
    ``mesh_cfg.num_devices`` ranks: the stats of the module docstring, and
    the ``Tally`` under ``"tally"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    cell = Cell(cfg, shape, mesh_cfg, plan_name, tc, device_mesh)
    stats = {"arch": cfg.name, "shape": shape.name,
             "mesh": "x".join(map(str, mesh_cfg.shape)),
             "execution": cell.execution}
    tally = Tally()
    flops = FlopCounterMode(display=False)
    with FakeTensorMode():
        args = cell.arguments()
        arg_bytes = sum(_nbytes(t) for t in tree_leaves(args))
        mem = MemTracker()
        mem.track_external(*tree_leaves(args))
        with kernel_standins(tally), counted_collectives(tally), mem, \
                flops, _GemmBytes(tally, flops.flop_registry):
            out = cell.step(*args)
        peak = mem.get_tracker_snapshot("peak")
    peak_bytes = max(d["Total"] for d in peak.values())
    # the trace's seconds, under the reference's key: nothing is compiled
    stats["compile_s"] = time.perf_counter() - t0
    stats["flops"] = float(flops.get_total_flops() + tally.kernel_flops)
    stats["hlo_bytes"] = float(tally.gemm_bytes + tally.kernel_bytes)
    stats["temp_size_in_bytes"] = peak_bytes - arg_bytes
    stats["argument_size_in_bytes"] = arg_bytes
    stats["output_size_in_bytes"] = sum(_nbytes(t) for t in tree_leaves(out)
                                        if isinstance(t, torch.Tensor))
    stats["generated_code_size_in_bytes"] = None      # nothing is compiled
    stats["collective_bytes"] = float(sum(tally.coll_bytes.values()))
    stats["collective_counts"] = dict(tally.coll_counts)
    stats["collective_bytes_by_kind"] = dict(tally.coll_bytes)
    stats["collective_bytes_by_link"] = dict(tally.link_bytes)
    # the trace unrolls every layer: the totals are the raw counts
    stats["scanned_raw"] = {k: stats[k] for k in
                            ("flops", "hlo_bytes", "collective_bytes")}
    stats["probe_s"] = None
    stats["kernel_flops"] = tally.kernel_flops
    stats["kernel_calls"] = _call_counts(tally)
    stats["peak_bytes"] = peak_bytes
    stats["fits_80gb"] = peak_bytes <= CARD_BYTES
    stats["roofline"] = roofline_row(cfg, shape, mesh_cfg, stats)
    stats["tally"] = tally
    return stats


def _call_counts(tally: Tally) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, _ in tally.kernel_calls:
        out[name] = out.get(name, 0) + 1
    return out


def roofline_row(cfg, shape, mesh_cfg, stats):
    rep = roofline.RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_cfg.shape,
        chips=mesh_cfg.num_devices,
        hlo_flops=stats.get("flops", 0.0),
        hlo_bytes=stats.get("hlo_bytes", 0.0),
        collective_bytes=stats.get("collective_bytes", 0.0),
        model_flops=roofline.model_flops(cfg, shape),
        link_bytes=stats.get("collective_bytes_by_link"))
    return rep.row()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default=None,
                    help="comma-separated arch filter for --all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--plan", default="bf16", choices=["bf16", "mpai"])
    ap.add_argument("--kv-cache", default="bfloat16",
                    choices=["bfloat16", "int8"],
                    help="KV cache dtype for decode cells")
    ap.add_argument("--no-compile", action="store_true",
                    help="accepted; nothing is compiled")
    ap.add_argument("--no-probe", action="store_true",
                    help="accepted; the trace unrolls every layer")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    mesh_cfg = production_mesh_config(multi_pod=args.multi_pod)
    print(f"mesh: {mesh_cfg.shape} {mesh_cfg.axes} "
          f"({mesh_cfg.num_devices} devices)")
    if args.all:
        todo = [(a, s) for a, s, _ in cells()]
        if args.archs:
            keep = set(args.archs.split(","))
            todo = [(a, s) for a, s in todo if a in keep]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    with fake_world(mesh_cfg.num_devices):
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        for arch, shape_name in todo:
            cfg = get_config(arch)
            if args.kv_cache != "bfloat16":
                cfg = cfg.with_(kv_cache_dtype=args.kv_cache)
            shape = SHAPES[shape_name]
            tag = (f"{arch}__{shape_name}__"
                   f"{'multi' if args.multi_pod else 'single'}")
            if args.plan != "bf16":
                tag += f"__{args.plan}"
            if args.kv_cache != "bfloat16":
                tag += "__kv8"
            print(f"=== {tag} ===", flush=True)
            try:
                stats = trace_cell(cfg, shape, mesh_cfg, args.plan,
                                   device_mesh=mesh)
                stats.pop("tally")
                r = stats["roofline"]
                print(f"  traced in {stats['compile_s']:.1f}s | "
                      f"flops/dev {stats['flops'] / 1e9:.1f}G | "
                      f"coll {stats['collective_bytes'] / 1e9:.2f}GB | "
                      f"dominant {r['dominant']} | "
                      f"terms c/m/x = {r['compute_ms']}/{r['memory_ms']}/"
                      f"{r['collective_ms']} ms", flush=True)
                print(f"  temp/dev {stats['temp_size_in_bytes'] / 1e9:.2f}GB "
                      f"args/dev {stats['argument_size_in_bytes'] / 1e9:.2f}GB"
                      f" fits 80 GB: {stats['fits_80gb']}", flush=True)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(stats, f, indent=1)
            except Exception as e:                       # noqa: BLE001
                failures.append((tag, repr(e)))
                traceback.print_exc()
    print(f"\n{len(todo) - len(failures)}/{len(todo)} cells OK")
    for tag, err in failures:
        print(f"FAIL {tag}: {err[:200]}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
