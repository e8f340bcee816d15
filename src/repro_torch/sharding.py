"""Partition specs: how every parameter, batch and cache shards over a
mesh (the port of ``repro.sharding``), and the placement of a spec on the
ranks of a ``torch.distributed`` device mesh.

Axes: ``pod`` (cross-pod DP / MPAI stage axis), ``data`` (DP; also the
FSDP shard axis for archs flagged ``fsdp=True``), ``model`` (TP/EP in the
reference).

Rules are name-based on the *trailing* dims of each leaf; extra leading
dims (the scan-stack layer dim, MoE expert dims handled explicitly) pad
with None.  This keeps one table covering every architecture family.  The
tables are the reference's statement for statement, so a spec tree here
equals the reference's entry by entry.

A spec is a :class:`PartitionSpec`: one entry per leading tensor dim,
each ``None`` (the dim is whole), an axis name, or a tuple of axis names
(the dim splits over their product, the first axis major, as JAX splits
it); dims past the last entry are whole.  ``shard_slices`` gives the index
ranges that the device at a mesh coordinate holds, the same ranges as the
reference's ``NamedSharding(mesh, spec).devices_indices_map(shape)``;
``shard`` and ``unshard`` (an all-gather over the axes a dim is split on)
build on it, and :class:`TreeSharding` applies them to a whole tree, as
the reference's ``make_shardings`` gives a tree of ``NamedSharding``.
Both can act on some axes only (``axes``): a step that computes
head-parallel gathers a leaf's data-axis parts and keeps its model-axis
part, the leaves that :func:`head_parallel` names.  :class:`BlockGather`
makes the same gathers one super-block of a stacked ``layers`` leaf at a
time, inside the model (``core/collectives.layer_gather``), where a data
axis splits the leaf (FSDP).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core import collectives
from repro_torch.core.tree import tree_leaves, tree_map

MODEL = "model"


class PartitionSpec:
    """An immutable tuple of per-dim entries (see the module docstring);
    iterates, indexes and compares like the reference's ``PartitionSpec``
    read as a tuple."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        # a one-axis tuple is that axis, as JAX normalizes it
        entries = tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                        else tuple(e) if isinstance(e, list) else e
                        for e in entries)
        object.__setattr__(self, "_entries", entries)

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Trees with paths (the reference walks ``jax.tree_util`` key paths)
# ---------------------------------------------------------------------------
def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, named tuples and sequences;
    a path entry is ``("key", k)``, ``("attr", field)`` or ``("idx", i)``,
    as ``DictKey``, ``GetAttrKey`` and ``SequenceKey`` in the reference."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (("key", k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (("attr", f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (("idx", i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _fsdp_axis(cfg: ModelConfig, mesh_cfg: Optional[MeshConfig] = None):
    if not cfg.fsdp:
        return None
    if mesh_cfg is not None and "pod" in mesh_cfg.axes:
        return ("pod", "data")        # ZeRO-3 over every DP axis
    return "data"


# trailing-dim spec tables -------------------------------------------------
def _trailing_spec(name: str, ndim: int, cfg: ModelConfig,
                   mesh_cfg: Optional[MeshConfig] = None):
    f = _fsdp_axis(cfg, mesh_cfg)
    # MoE expert tensors (expert dim sharded over model = EP)
    if name in ("w_in", "w_gate") and ndim == 3:
        return (MODEL, f, None)
    if name == "w_out" and ndim == 3:
        return (MODEL, None, f)
    table = {
        # attention
        "wq": (f, MODEL), "wk": (f, MODEL), "wv": (f, MODEL),
        "wo": (MODEL, f),
        # dense MLP
        "w_in": (f, MODEL), "w_gate": (f, MODEL), "w_out": (MODEL, f),
        # router (tiny, accuracy-critical: replicated)
        "router": (None, None),
        # mamba
        "in_proj": (f, MODEL), "out_proj": (MODEL, f),
        "x_proj": (MODEL, None), "dt_proj": (None, MODEL),
        "conv_w": (None, MODEL), "conv_b": (MODEL,),
        "dt_bias": (MODEL,), "A_log": (MODEL, None), "D": (MODEL,),
        # rwkv time-mix
        "w_r": (f, MODEL), "w_k": (f, MODEL), "w_v": (f, MODEL),
        "w_g": (f, MODEL), "w_o": (MODEL, f),
        "w0": (MODEL,), "wB": (None, MODEL), "u": (MODEL,),
        "gn_scale": (MODEL,), "gn_bias": (MODEL,),
        # rwkv channel-mix
        "w_kc": (f, MODEL), "w_vc": (MODEL, f), "w_rc": (f, MODEL),
    }
    return table.get(name)


def _leaf_name(path) -> str:
    """Last meaningful name: skips QTensor field entries (values/scale are
    attributes under the named weight)."""
    for kind, name in reversed(path):
        if kind == "key":
            return str(name)
        if kind == "attr" and name not in ("values", "scale"):
            return name
    return ""


def _dp_axes(mesh_cfg: Optional[MeshConfig]):
    axes = mesh_cfg.axes if mesh_cfg is not None else ("data", "model")
    return tuple(a for a in ("pod", "data", "model") if a in axes)


def _sanitize(spec_tuple, shape, mesh_cfg: Optional[MeshConfig]):
    """None out axes on size-1 dims (QTensor scales) and assert the rest."""
    out = []
    for dim, ax in zip(shape, spec_tuple):
        out.append(None if (ax is not None and dim == 1) else ax)
    return tuple(out)


def param_specs(cfg: ModelConfig, params_shape,
                mesh_cfg: Optional[MeshConfig] = None) -> object:
    """PartitionSpec tree matching ``params_shape`` (a tree of tensors,
    ``meta`` ones included).  Handles QTensor leaves (values share the
    float weight's spec; broadcast scale dims replicate)."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape)) if mesh_cfg else \
        {"data": 16, "model": 16}

    def spec(path, leaf):
        name = _leaf_name(path)
        nd = len(leaf.shape)
        top = str(path[0][1]) if path[0][0] == "key" else ""
        in_stack = top == "layers"
        trail_nd = nd - (1 if in_stack else 0)
        if cfg.sharding_mode == "fsdp" and cfg.moe is None:
            comb = _dp_axes(mesh_cfg)
            total = 1
            for a in comb:
                total *= sizes.get(a, 1)
            if top in ("embed", "lm_head"):
                if leaf.shape[0] % total == 0:
                    return P(comb, None)
                return P(MODEL, None)      # vocab not mesh-divisible
            if trail_nd >= 2:
                # shard the first trailing dim divisible by the full mesh
                dims = leaf.shape[-trail_nd:]
                tsp = [None] * trail_nd
                for i, dsz in enumerate(dims):
                    if dsz % total == 0:
                        tsp[i] = comb
                        break
                tsp = _sanitize(tuple(tsp), dims, mesh_cfg)
                return P(*(((None,) if in_stack else ()) + tuple(tsp)))
            return P()
        if top in ("embed", "lm_head"):
            # vocab-sharded only: FSDP-sharding the table's d_model dim makes
            # the token gather unpartitionable in the reference's SPMD
            # lowering — the table is small relative to the blocks anyway
            return P(MODEL, None)
        tspec = _trailing_spec(name, trail_nd, cfg, mesh_cfg)
        if tspec is None:
            return P()                                 # norms, scalars, mus
        assert len(tspec) == trail_nd, (name, leaf.shape, tspec)
        tspec = _sanitize(tuple(tspec), leaf.shape[-trail_nd:], mesh_cfg)
        return P(*(((None,) if in_stack else ()) + tuple(tspec)))
    return _map_with_path(spec, params_shape)


# the leaves that the model axis splits compute over under ``sharding_mode
# == "tp"``, by the sublayer part they sit in: attention's projections, and
# Mamba's and RWKV-6's time-mix leaves (``mixer``); the dense MLPs, MoE
# experts (the shared expert too) and RWKV-6's channel mix (``mlp``); with
# ``embed`` and ``lm_head``.  Under ``sharding_mode == "fsdp"``, or on a
# model axis of one rank, every leaf computes replicated
HEAD_PARALLEL = {"mixer": ("wq", "wk", "wv", "wo",
                           # Mamba
                           "in_proj", "x_proj", "dt_proj", "conv_w",
                           "conv_b", "dt_bias", "A_log", "D", "out_proj",
                           # RWKV-6 time mix
                           "w_r", "w_k", "w_v", "w_g", "wB", "w0", "u",
                           "gn_scale", "gn_bias", "w_o"),
                 "mlp": ("w_in", "w_gate", "w_out",
                         # RWKV-6 channel mix
                         "w_kc", "w_vc", "w_rc")}
# head-parallel leaves whose split dim is two halves that the model splits
# apart after the product: Mamba's ``in_proj`` (``[x | z]``, each
# ``d_inner`` wide).  The spec cuts the dim contiguously, so a rank stores
# no part of both halves: ``TreeSharding.unshard`` re-lays it where it
# keeps the model-axis part, and ``TreeSharding.shard`` lays it back
HALVES = {"mixer": ("in_proj",)}


def _in_layer_part(path, names) -> bool:
    keys = [str(n) for kind, n in path if kind == "key"]
    return (keys[:1] == ["layers"] and len(keys) >= 4
            and _leaf_name(path) in names.get(keys[2], ()))


def head_parallel(cfg: ModelConfig, params_shape, mesh_cfg: MeshConfig):
    """A tree of bools matching ``params_shape``: True where a leaf is
    computed on the rank's model-axis part (column- and row-parallel
    projections, head-local attention, the recurrent mixers on the rank's
    heads and channels, the vocab-parallel embedding and head,
    expert-parallel MoE; ``models/*``).  None where the model axis
    computes replicated: it has one rank, or ``cfg.sharding_mode ==
    "fsdp"`` (pure ZeRO-3 splits the batch over it)."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    if cfg.sharding_mode != "tp" or sizes.get(MODEL, 1) == 1:
        return None

    def pred(path, leaf) -> bool:
        if str(path[0][1]) in ("embed", "lm_head"):
            return True
        return _in_layer_part(path, HEAD_PARALLEL)
    return _map_with_path(pred, params_shape)


# ---------------------------------------------------------------------------
# Data / cache / logits specs
# ---------------------------------------------------------------------------
def batch_axes(global_batch: int, mesh_cfg: MeshConfig,
               include_model: bool = False):
    """Largest prefix of the DP axes that divides the batch."""
    pool = ("pod", "data", "model") if include_model else ("pod", "data")
    axes = [a for a in pool if a in mesh_cfg.axes]
    sizes = {a: mesh_cfg.shape[mesh_cfg.axes.index(a)] for a in axes}
    chosen, div = [], 1
    for a in axes:
        if global_batch % (div * sizes[a]) == 0:
            chosen.append(a)
            div *= sizes[a]
    return tuple(chosen) or None


def data_specs(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig):
    b_ax = batch_axes(shape.global_batch, mesh_cfg,
                      include_model=cfg.sharding_mode == "fsdp")
    tok = P(b_ax, None)
    out = {"tokens": tok}
    if shape.kind == "train":
        out["labels"] = tok
    if cfg.frontend != "none" and shape.kind in ("train", "prefill"):
        out["frontend_embeds"] = P(b_ax, None, None)
    return out


def cache_specs(cfg: ModelConfig, cache_shape, shape: ShapeConfig,
                mesh_cfg: MeshConfig):
    """Spec tree matching the stacked decode cache
    (``launch.specs.cache_structs``)."""
    b_ax = batch_axes(shape.global_batch, mesh_cfg)

    def spec(path, leaf):
        nd = len(leaf.shape)
        name = _leaf_name(path)
        if nd <= 1:                                   # pos scalars [L]
            return P()
        if name in ("k", "v"):                        # [L, B, T, KVp, hd]
            return P(None, b_ax, None, MODEL, None)
        if name in ("k_scale", "v_scale"):            # [L, B, T, KVp, 1]
            return P(None, b_ax, None, MODEL, None)
        if name == "h":                               # mamba [L, B, di, N]
            return P(None, b_ax, MODEL, None)
        if name == "conv":                            # [L, B, k, di]
            return P(None, b_ax, None, MODEL)
        if name == "s":                               # rwkv [L, B, Hp, N, N]
            return P(None, b_ax, MODEL, None, None)
        if name in ("x_tmix", "x_cmix"):              # [L, B, D]
            return P(None, b_ax, None)
        return P(*((None,) * nd))
    return _map_with_path(spec, cache_shape)


def logits_spec(shape: ShapeConfig, mesh_cfg: MeshConfig):
    return P(batch_axes(shape.global_batch, mesh_cfg), None, MODEL)


# ---------------------------------------------------------------------------
# Placement on ranks
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dim_axes(spec: PartitionSpec, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """The axes each of ``ndim`` dims splits over (``()``: whole)."""
    return tuple(_entry_axes(spec[i]) if i < len(spec) else ()
                 for i in range(ndim))


def shard_slices(spec: PartitionSpec, global_shape: Sequence[int],
                 mesh_cfg: MeshConfig, coord) -> Tuple[slice, ...]:
    """The index ranges of a ``global_shape`` tensor that the device at
    mesh coordinate ``coord`` (a dict by axis name, or a sequence in
    ``mesh_cfg.axes`` order) holds under ``spec``: a dim split over axes
    ``(a, b)`` is cut into ``|a| * |b|`` parts of ``ceil(dim / parts)``
    (the last may be short), part ``coord[a] * |b| + coord[b]``."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    if not isinstance(coord, dict):
        coord = dict(zip(mesh_cfg.axes, coord))
    out = []
    for dim, axes in zip(global_shape, dim_axes(spec, len(global_shape))):
        parts, idx = 1, 0
        for a in axes:
            parts *= sizes[a]
            idx = idx * sizes[a] + coord[a]
        chunk = -(-dim // parts)
        start = min(idx * chunk, dim)
        out.append(slice(start, min(start + chunk, dim)))
    return tuple(out)


def local_shape(spec: PartitionSpec, global_shape: Sequence[int],
                mesh_cfg: MeshConfig, coord) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in
                 shard_slices(spec, global_shape, mesh_cfg, coord))


def uneven_dims(spec: PartitionSpec, global_shape: Sequence[int],
                mesh_cfg: MeshConfig) -> list:
    """The dims of ``global_shape`` that ``spec`` does not split evenly."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    out = []
    for i, (dim, axes) in enumerate(zip(
            global_shape, dim_axes(spec, len(global_shape)))):
        parts = 1
        for a in axes:
            parts *= sizes[a]
        if dim % parts:
            out.append(i)
    return out


def over_axes(spec: PartitionSpec, ndim: int,
              axes: Sequence[str]) -> PartitionSpec:
    """``spec`` with only the splits over ``axes``: a dim split over other
    axes reads as whole (a dim split over both is refused)."""
    out = []
    for dim_ax in dim_axes(spec, ndim):
        inside = tuple(a for a in dim_ax if a in axes)
        if inside and len(inside) != len(dim_ax):
            raise ValueError(f"{spec} splits a dim over {dim_ax}: acting on "
                             f"{tuple(axes)} alone would cut it")
        out.append(inside or None)
    return P(*out)


def shard(full: torch.Tensor, spec: PartitionSpec, mesh_cfg: MeshConfig,
          coord, axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The part of ``full`` that the device at ``coord`` holds, in storage
    of its own (``full`` itself where the spec splits nothing).  With
    ``axes``, only the splits over those axes are cut (``full`` is whole
    along them, and already the rank's part along the others)."""
    if axes is not None:
        spec = over_axes(spec, full.ndim, axes)
    sl = shard_slices(spec, full.shape, mesh_cfg, coord)
    if all(s.stop - s.start == d for s, d in zip(sl, full.shape)):
        return full
    return full[sl].clone(memory_format=torch.contiguous_format)


def unshard(local: torch.Tensor, spec: PartitionSpec,
            global_shape: Sequence[int], mesh_cfg: MeshConfig,
            group_of: Callable,
            axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The whole tensor from this rank's part ``local``: for each split
    dim an all-gather over the process group of its axes
    (``group_of(axes)``, whose ranks are in the part order), concatenated
    along the dim.  ``local`` itself where nothing is split.  With
    ``axes``, only the splits over those axes are gathered: the result is
    whole along them and the rank's part along the others.  Needs even
    splits (``uneven_dims`` empty)."""
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    if axes is not None:            # the shape along the other axes: parts
        n = len(global_shape)
        whole = dim_axes(spec, n)
        spec = over_axes(spec, n, axes)
        global_shape = tuple(
            d if act == ax else d // int(np.prod([sizes[a] for a in ax]))
            for d, ax, act in zip(global_shape, whole, dim_axes(spec, n)))
    out = local
    for i, dim_ax in enumerate(dim_axes(spec, len(global_shape))):
        parts = 1
        for a in dim_ax:
            parts *= sizes[a]
        if parts == 1:
            continue
        if list(dim_ax) != sorted(dim_ax, key=mesh_cfg.axes.index):
            # a group's ranks run in the mesh's axis order
            raise ValueError(f"unshard: {spec} splits a dim over {dim_ax}, "
                             f"not in the mesh's order {mesh_cfg.axes}")
        out = out.contiguous()
        bufs = [torch.empty_like(out) for _ in range(parts)]
        torch.distributed.all_gather(bufs, out, group=group_of(dim_ax))
        out = torch.cat(bufs, dim=i)
    if tuple(out.shape) != tuple(global_shape):
        raise ValueError(f"unshard: gathered {tuple(out.shape)}, expected "
                         f"{tuple(global_shape)} (spec {spec})")
    return out


class Placement:
    """This rank's place on a ``torch.distributed`` device mesh: its
    coordinate and the process group over each tuple of axes.  A single
    axis's group is the mesh's own; a group over several axes (``("pod",
    "data")``) is made once, by every rank, with ``dist.new_group`` over
    each sub-grid of the mesh, and kept.  Since ranks fill the mesh in
    row-major order and tuples follow the mesh's axis order, a group's
    ranks, sorted, run in the part order of ``shard_slices``."""

    def __init__(self, mesh_cfg: MeshConfig, device_mesh):
        self.mesh_cfg = mesh_cfg
        self.mesh = device_mesh
        self.coord: Dict[str, int] = dict(zip(
            mesh_cfg.axes, device_mesh.get_coordinate()))
        self.rank = torch.distributed.get_rank()
        self._grid = np.arange(mesh_cfg.num_devices).reshape(mesh_cfg.shape)
        self._groups: Dict[Tuple[str, ...], object] = {}

    def group(self, axes: Sequence[str]):
        axes = tuple(a for a in self.mesh_cfg.axes if a in axes)
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        if axes not in self._groups:
            import torch.distributed as dist
            keep = [self.mesh_cfg.axes.index(a) for a in axes]
            rest = [i for i in range(len(self.mesh_cfg.axes))
                    if i not in keep]
            rows = self._grid.transpose(rest + keep).reshape(
                -1, self.group_size(axes))
            for row in rows:          # every rank makes every group
                g = dist.new_group([int(r) for r in row])
                if self.rank in row:
                    self._groups[axes] = g
        return self._groups[axes]

    def group_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a, s in zip(self.mesh_cfg.axes, self.mesh_cfg.shape):
            if a in axes:
                n *= s
        return n


class TreeSharding:
    """A tree of specs and global shapes placed on a mesh (the counterpart
    of the reference's tree of ``NamedSharding``): ``shard`` keeps this
    rank's part of each leaf of a whole tree, ``unshard`` gathers a tree of
    parts back to whole leaves (collective: every rank calls it)."""

    def __init__(self, placement: Placement, specs, shapes):
        self.placement = placement
        self.specs = specs
        self.shapes = shapes
        # the leaves whose model-axis part is two halves' (``HALVES``; a
        # QTensor's per-tensor scale is not split)
        self.halves = tree_map(
            lambda m, sp, t: m and MODEL in dim_axes(sp, t.ndim)[-1],
            _map_with_path(lambda path, t: _in_layer_part(path, HALVES),
                           shapes), specs, shapes)

    @property
    def is_writer(self) -> bool:
        """The rank that writes what every rank holds (rank 0)."""
        return self.placement.rank == 0

    def barrier(self) -> None:
        torch.distributed.barrier()

    def slices(self, spec: PartitionSpec, global_shape) -> Tuple[slice, ...]:
        """This rank's index ranges of a leaf under ``spec``."""
        pl = self.placement
        return shard_slices(spec, global_shape, pl.mesh_cfg, pl.coord)

    def _axes(self, keep_model):
        """Per leaf, the axes to act on: all (None), or every axis but the
        model axis where ``keep_model`` (a tree of bools, e.g.
        :func:`head_parallel`'s) is True."""
        if keep_model is None:
            return tree_map(lambda sp: None, self.specs)
        rest = tuple(a for a in self.placement.mesh_cfg.axes if a != MODEL)
        return tree_map(lambda keep: rest if keep else None, keep_model)

    def _relay(self, tree, keep_model, back: bool):
        """``tree`` with each kept leaf of ``self.halves`` re-laid from the
        rank's stored model-axis part to its part of each half, or back
        (``collectives.model_halves``, an all-to-all over the model axis)."""
        pl = self.placement
        if keep_model is None or pl.group_size((MODEL,)) == 1:
            return tree
        group = pl.group((MODEL,))
        ranks, rank = pl.group_size((MODEL,)), pl.coord[MODEL]
        return tree_map(lambda t, keep, m: collectives.model_halves(
            t, group, ranks, rank, back) if keep and m else t,
            tree, keep_model, self.halves)

    def shard(self, full, keep_model=None, blocks=None):
        """This rank's part of each leaf of ``full``; where ``keep_model``
        is True the leaf is already the rank's model-axis part, laid as
        ``unshard`` lays it, and only its other axes are cut (collective
        where a kept leaf is two halves' part: every rank calls it).
        Where ``blocks`` (``BlockGather.leaves``) is True the leaf is
        already the rank's part, and is only laid back."""
        pl = self.placement
        full = self._relay(full, keep_model, back=True)
        return tree_map(lambda t, sp, ax, blk: t if blk else shard(
            t, sp, pl.mesh_cfg, pl.coord, ax), full, self.specs,
            self._axes(keep_model), self._blocks(blocks))

    def unshard(self, local, keep_model=None, blocks=None):
        """Every leaf gathered whole; where ``keep_model`` is True only
        its non-model axes are gathered, and a part of two halves
        (``HALVES``, Mamba's ``in_proj``) is re-laid to the rank's part of
        each, as the model computes on it (collective: every rank calls
        it).  Where ``blocks`` (``BlockGather.leaves``) is True the leaf
        stays the rank's part, re-laid where it is two halves': the model
        gathers it a super-block at a time."""
        pl = self.placement
        return self._relay(tree_map(lambda t, sp, like, ax, blk: t if blk
                                    else unshard(t, sp, like.shape,
                                                 pl.mesh_cfg, pl.group, ax),
                                    local, self.specs, self.shapes,
                                    self._axes(keep_model),
                                    self._blocks(blocks)),
                           keep_model, back=False)

    def _blocks(self, blocks):
        return tree_map(lambda sp: False, self.specs) if blocks is None \
            else blocks

    def block_gather(self, keep_model=None) -> Optional["BlockGather"]:
        """The per-block gather of this tree's stacked ``layers`` (the
        leaves ``unshard`` gathers over a split axis, with ``keep_model``
        as it takes it), or None where no layer leaf is split so."""
        bg = BlockGather(self, keep_model)
        return bg if any(tree_leaves(bg.leaves)) else None


class _LeafGather:
    """How ``BlockGather`` reads one leaf of a super-block: ``gather`` and
    ``cut`` (its all-gathers and the rank's part of a block), and the
    split axes they act on; ``gather`` None where the leaf is whole."""
    __slots__ = ("gather", "cut", "axes")

    def __init__(self, gather=None, cut=None, axes=()):
        self.gather, self.cut, self.axes = gather, cut, axes


class BlockGather:
    """Super-block ``i`` of a stacked ``layers`` tree whose split leaves
    are this rank's parts (``TreeSharding.unshard(..., blocks=leaves)``
    leaves them so): each is ``a[i]`` gathered by the all-gathers that
    ``unshard`` makes for the whole leaf, over the same groups in the
    same part order (the stack dim is never split, so dim ``d`` of the
    block is dim ``d + 1`` of the stack), through
    ``collectives.gather_block``, whose backward all-reduces the block's
    gradient over the batch group and cuts the rank's part (``shard``).
    A layer leaf that ``unshard`` gathers over no split axis (a norm, the
    router, a head-parallel leaf split on the model axis alone) is whole
    and indexed as it is.  Called through ``collectives.layer_gather``.
    ``plans`` holds a ``_LeafGather`` for every leaf of the state's tree,
    ``leaves`` is True where a leaf is gathered so (for ``unshard`` and
    ``shard``)."""

    def __init__(self, ts: TreeSharding, keep_model=None):
        pl = ts.placement
        sizes = dict(zip(pl.mesh_cfg.axes, pl.mesh_cfg.shape))

        def plan(in_layers, sp, like, ax):
            nd = like.ndim
            acting = sp if ax is None else over_axes(sp, nd, ax)
            axes = tuple(d for d in dim_axes(acting, nd)
                         if int(np.prod([sizes[a] for a in d])) > 1)
            if not (in_layers and axes):
                return _LeafGather()
            if dim_axes(acting, nd)[0]:
                raise ValueError(f"{sp} splits a stacked leaf's layer dim")
            spec, shape = P(*tuple(sp)[1:]), tuple(like.shape[1:])
            return _LeafGather(
                lambda part: unshard(part, spec, shape, pl.mesh_cfg,
                                     pl.group, ax),
                lambda g: shard(g, spec, pl.mesh_cfg, pl.coord, ax), axes)
        in_layers = _map_with_path(
            lambda path, t: str(path[0][1]) == "layers", ts.shapes)
        self.plans = tree_map(plan, in_layers, ts.specs, ts.shapes,
                              ts._axes(keep_model))
        self.leaves = tree_map(lambda p: p.gather is not None, self.plans)

    def __call__(self, layers, i: int):
        return tree_map(lambda a, p: a[i] if p.gather is None else
                        collectives.gather_block(a[i], p.gather, p.cut),
                        layers, self.plans["layers"])
