"""The batch group and the model group: the ranks among which a mesh step
splits its global batch, and the ranks among which it splits the model's
heads, vocab and experts, as the model's functions see them.

The reference's jitted step on a mesh reads whole tensors: a per-tensor
activation scale takes the absmax of the global batch, and MoE routing
counts the global batch's tokens (its dispatch path and its
load-balancing loss).  The port's mesh ``Trainer`` runs the forward and
backward on the rank's rows only, so it enters :func:`batch_group` around
them, and the functions that couple rows across the batch reduce over the
group:

* :func:`batch_max` — an activation's absmax, all-reduced with
  ``ReduceOp.MAX`` (no gradient: a scale is a constant to the STE);
* :func:`batch_sum` — a differentiable all-reduce sum, whose backward is
  the same all-reduce of the incoming gradient.  With the step's mean of
  the ranks' gradients, the gradient of a loss built from the sum is
  exactly that of the loss on the global batch;
* :func:`batch_ranks` — the group's size: every rank holds the same number
  of rows, so the global token count is the rank's times this, with no
  collective and no wait for the host.

The model group (:func:`model_group`) is the model axis under
``sharding_mode == "tp"``: each rank holds its part of the attention
heads, the dense MLPs' hidden units, the vocab and the MoE experts, and
computes on that part alone (``sharding.head_parallel``).  Every other
value (the residual stream, norms, the router, the loss) is replicated:
the same bits on every rank of the group.  Megatron's conjugate pair keeps
it so:

* :func:`to_model` — identity forward, all-reduce of the gradient in the
  backward: the input of a column-parallel block, whose gradient each
  rank holds only the part of that its columns give;
* :func:`from_model` — all-reduce forward, identity backward: the output
  of a row-parallel block, whose partial sums each rank holds;

with :func:`model_max` (an exact ``MAX`` of a scale's absmax, no
gradient), :func:`model_gather` (an all-gather along a dim, whose
backward keeps the rank's part), :func:`model_halves` (an all-to-all
over an explicit group that re-lays a weight whose split dim holds two
halves, Mamba's ``in_proj``) and :func:`model_rank` / :func:`model_ranks`.
``core/quantization.pdot`` folds the pair into its split products, in
f32: a column-parallel product all-reduces its
input's gradient, a row-parallel one its output.  The ring all-reduces
of gloo and NCCL hand every rank the same bits, so what is replicated
stays identical.

The layer gather (:func:`layer_gather`) is the FSDP split of the stacked
layers: where a data axis splits a ``layers`` leaf, each rank holds its
part of every super-block, and the model reads super-block ``i`` through
:func:`layer_block`, which all-gathers that block's parts as the forward,
remat's recompute and the backward reach it (``sharding.BlockGather``).
Its backward all-reduces the gathered block's gradient over the batch
group and keeps the rank's part, so a whole stacked leaf is never
gathered and its gradient is the rank's slice, reduced.

Outside a group (one device, or a mesh whose batch is whole on every rank)
every function returns its input and the model runs exactly as it does
alone.  A group of one rank is no group.  Every rank of a group runs the
same program on same-shaped rows, so the collectives come in one order on
every rank, remat's recompute in the backward included.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.tree import tree_map

_GROUP = None          # the process group of the batch axes, or None
_RANKS = 1
_MGROUP = None         # the process group of the model axis, or None
_MRANKS = 1
_MRANK = 0
_BLOCK = None          # (layers, i) -> super-block i, gathered; or None


@contextlib.contextmanager
def batch_group(group, ranks: int):
    """While inside, the model's functions reduce over ``group`` (a
    ``torch.distributed`` process group of ``ranks`` ranks that split the
    batch in equal parts); ``ranks == 1`` enters no group."""
    global _GROUP, _RANKS
    saved = _GROUP, _RANKS
    _GROUP, _RANKS = (group, ranks) if ranks > 1 else (None, 1)
    try:
        yield
    finally:
        _GROUP, _RANKS = saved


def batch_ranks() -> int:
    """The number of ranks that split the batch (1 outside a group)."""
    return _RANKS


def batch_max(amax: torch.Tensor) -> torch.Tensor:
    """``amax`` (a detached absmax) all-reduced with ``MAX`` over the
    batch group, in place; ``amax`` itself outside one."""
    if _GROUP is not None:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_GROUP)
    return amax


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the batch group's ranks, differentiable (its
    backward sums the ranks' incoming gradients); ``t`` itself outside a
    group."""
    if _GROUP is None:
        return t
    return _SumOverGroup.apply(t, _GROUP)


# ---------------------------------------------------------------------------
# The model group
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def model_group(group, ranks: int, rank: int):
    """While inside, the model's head-parallel functions compute on this
    rank's part (``rank`` of ``ranks``, in ``group``'s order) of the model
    axis; ``ranks == 1`` enters no group."""
    global _MGROUP, _MRANKS, _MRANK
    saved = _MGROUP, _MRANKS, _MRANK
    _MGROUP, _MRANKS, _MRANK = ((group, ranks, rank) if ranks > 1
                                else (None, 1, 0))
    try:
        yield
    finally:
        _MGROUP, _MRANKS, _MRANK = saved


def model_ranks() -> int:
    """The number of ranks that split the model (1 outside a group)."""
    return _MRANKS


def model_rank() -> int:
    """This rank's part of the model axis (0 outside a group)."""
    return _MRANK


def model_process_group():
    """The model group's process group (None outside a group)."""
    return _MGROUP


def model_max(amax: torch.Tensor) -> torch.Tensor:
    """``amax`` (a detached absmax) all-reduced with ``MAX`` over the
    model group, in place; ``amax`` itself outside one."""
    if _MGROUP is not None:
        import torch.distributed as dist
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_MGROUP)
    return amax


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _all_reduce(g, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def to_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` (replicated) as the input of a column-parallel block: its
    gradient is summed over the model group's ranks; ``t`` itself outside
    a group."""
    if _MGROUP is None:
        return t
    return _ToModel.apply(t, _MGROUP)


def from_model(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each rank's partial ``t`` (a
    row-parallel block's output), replicated; the gradient passes as it
    is.  ``t`` itself outside a group."""
    if _MGROUP is None:
        return t
    return _FromModel.apply(t, _MGROUP)


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, dim: int, group, ranks: int,
                rank: int) -> torch.Tensor:
        import torch.distributed as dist
        ctx.dim, ctx.rank, ctx.size = dim, rank, t.shape[dim]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(ranks)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        lo = ctx.rank * ctx.size
        return g.narrow(ctx.dim, lo, ctx.size), None, None, None, None


def model_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts ``t`` concatenated along ``dim`` in rank order
    (an all-gather), replicated; the gradient of a replicated consumer is
    the rank's part of the incoming one.  ``t`` itself outside a group."""
    if _MGROUP is None:
        return t
    return _GatherModel.apply(t, dim, _MGROUP, _MRANKS, _MRANK)


def _halves_route(n: int, j: int, back: bool):
    """The all-to-all of :func:`model_halves` on rank ``j`` of ``n``.  The
    whole dim is ``2n`` pieces (``a`` is pieces ``0 .. n-1``, ``b`` the
    rest); rank ``j`` stores pieces ``2j, 2j + 1`` and computes on ``j, n
    + j``.  Returns (the rank's two pieces in the order they are sent, the
    rank each goes to, the rank each of the two it keeps comes from)."""
    held, want = ((2 * j, 2 * j + 1), (j, n + j))[::-1 if back else 1]
    stored_on, computed_on = (lambda c: c // 2), (lambda c: c % n)
    to, frm = ((computed_on, stored_on) if not back
               else (stored_on, computed_on))
    send = sorted(range(2), key=lambda i: to(held[i]))
    return send, [to(held[i]) for i in send], [frm(c) for c in want]


def _halves_pack(t: torch.Tensor, n: int, j: int, back: bool):
    """What rank ``j`` of ``n`` sends in :func:`model_halves`: its two
    pieces of ``t``, stacked on dim 0 in the order of the ranks they go
    to, and the all-to-all's (output, input) split sizes."""
    send, to, frm = _halves_route(n, j, back)
    q = t.shape[-1] // 2
    buf = t.detach().reshape(-1, 2, q).transpose(0, 1)[send].contiguous()
    return (buf, [frm.count(r) for r in range(n)],
            [to.count(r) for r in range(n)])


def _halves_unpack(got: torch.Tensor, n: int, j: int, back: bool,
                   shape) -> torch.Tensor:
    """Rank ``j``'s re-laid tensor of ``shape`` from the two pieces it
    received, which arrive in the order of the ranks they come from."""
    frm = _halves_route(n, j, back)[2]
    order = sorted(range(2), key=lambda i: frm[i])
    got = got[[order.index(i) for i in range(2)]]
    return got.transpose(0, 1).reshape(shape)


def model_halves(t: torch.Tensor, group, ranks: int, rank: int,
                 back: bool = False) -> torch.Tensor:
    """Re-lay a weight whose last dim is two halves ``[a | b]`` split over
    the model group contiguously (Mamba's ``in_proj``, ``[x | z]``): from
    the rank's stored part (the ``ranks`` equal parts of the whole dim, so
    that at two ranks rank 0 holds ``a`` and rank 1 ``b``) to the rank's
    part of each half, ``[a_r | b_r]``, which the model computes on;
    ``back`` lays such a tensor (the weight's gradient) back as it is
    stored.  One ``all_to_all_single`` over ``group`` (the model axis's
    ``ranks`` ranks, this one ``rank``), in which each rank sends and
    receives the two halves of its part; no gradient.
    ``sharding.TreeSharding`` calls it where it gathers or cuts such a
    leaf with ``keep_model``."""
    import torch.distributed as dist
    buf, out_splits, in_splits = _halves_pack(t, ranks, rank, back)
    got = torch.empty_like(buf)
    dist.all_to_all_single(got, buf, out_splits, in_splits, group=group)
    return _halves_unpack(got, ranks, rank, back, t.shape)


# ---------------------------------------------------------------------------
# The layer gather
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def layer_gather(block):
    """While inside, :func:`layer_block` reads super-block ``i`` of the
    stacked layers as ``block(layers, i)`` (a ``sharding.BlockGather``:
    the leaves a data axis splits are the rank's parts, gathered block by
    block); ``block`` None enters nothing."""
    global _BLOCK
    saved = _BLOCK
    _BLOCK = block
    try:
        yield
    finally:
        _BLOCK = saved


def layer_block(layers, i: int):
    """Super-block ``i`` of the stacked ``layers``: each leaf's ``a[i]``,
    or inside :func:`layer_gather` the block its gather gives."""
    if _BLOCK is None:
        return tree_map(lambda a: a[i], layers)
    return _BLOCK(layers, i)


class _GatherBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part: torch.Tensor, gather, cut, group) -> torch.Tensor:
        ctx.cut, ctx.group = cut, group
        return gather(part)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.group is not None:
            g = _all_reduce(g, ctx.group)
        return ctx.cut(g), None, None, None


def gather_block(part: torch.Tensor, gather, cut) -> torch.Tensor:
    """``gather(part)``, one super-block's leaf gathered from the rank's
    ``part`` (its all-gathers); the backward all-reduces the gathered
    gradient over the batch group (the sum of every rank's rows) and
    returns ``cut(g)``, the rank's part of it."""
    return _GatherBlock.apply(part, gather, cut, _GROUP)
