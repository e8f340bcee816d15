"""The batch group: the ranks among which a mesh step splits its global
batch, as the model's functions see them.

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

Outside a group (one device, or a mesh whose batch is whole on every rank)
every function returns its input and the model runs exactly as it does
alone.  A group of one rank is no group.  Every rank of a group runs the
same program on same-shaped rows, so the collectives come in one order on
every rank, remat's recompute in the backward included.
"""
from __future__ import annotations

import contextlib

import torch

_GROUP = None          # the process group of the batch axes, or None
_RANKS = 1


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
