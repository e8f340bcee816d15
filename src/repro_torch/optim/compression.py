"""Int8 gradient compression for the data-parallel hop (the port of
``repro.optim.compression``).

The links between data-parallel groups are the scarcest bandwidth of a
training mesh.  This is the standard chunk-scaled int8 all-reduce: each
rank quantizes its gradient with one f32 scale per chunk of ``CHUNK``
elements, all-gathers the (int8, scale) pairs over the process group and
averages the dequantized copies in f32, in rank order (as XLA runs the
reference: see ``_gathered_mean``) — 4x fewer bytes than an f32
all-reduce, ~2x fewer than bf16.  It reuses the MPAI quantizer (symmetric
absmax, the scale computed as XLA runs the reference: ``amax`` times the
f32 reciprocal of 127, ``x / scale`` a true division, rounded half to
even), applied to another tensor class.  A ``torch.distributed`` process
group (the world by default) takes the place of the reference's mesh axis;
it works on whatever device its tensors live on (gloo on the CPU, NCCL on
the card).

Error feedback (carrying each rank's quantization residual into its next
step) keeps the bias bounded across steps.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.kernels.quant import INV_QMAX

CHUNK = 2048
QMAX = 127.0


def _chunk_quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes ``[nchunk, CHUNK]`` and scales ``[nchunk, 1]`` of ``x``
    (zero-padded to whole chunks)."""
    flat = x.reshape(-1)
    c = F.pad(flat, (0, (-flat.numel()) % CHUNK)).reshape(-1, CHUNK)
    scale = c.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * INV_QMAX
    q = torch.div(c, scale).round_().clamp_(-QMAX, QMAX)
    return q.to(torch.int8), scale


def _reshape(c: torch.Tensor, shape) -> torch.Tensor:
    return c.reshape(-1)[:math.prod(shape)].reshape(shape)


def _chunk_dequant(q: torch.Tensor, scale: torch.Tensor,
                   shape) -> torch.Tensor:
    return _reshape(q.float() * scale, shape)


def _gathered_mean(q: torch.Tensor, scale: torch.Tensor, shape,
                   group=None) -> torch.Tensor:
    """The f32 mean over the group of every rank's dequantized codes.

    XLA fuses each rank's dequantize product into the running sum, one
    fused multiply-add a rank from rank 0, and multiplies the sum by the
    f32 reciprocal of the rank count.  The products are exact in float64,
    so rounding each partial sum to f32 once gives the fused result."""
    world = dist.get_world_size(group)
    qs = q.new_empty((world * q.shape[0], CHUNK))
    ss = scale.new_empty((world * scale.shape[0], 1))
    dist.all_gather_into_tensor(qs, q, group=group)
    dist.all_gather_into_tensor(ss, scale, group=group)
    deq = (qs.double() * ss.double()).reshape(world, -1, CHUNK)
    acc = deq[0].float()
    for r in range(1, world):
        acc = (acc.double() + deq[r]).float()
    return _reshape(acc * _reciprocal(world), shape)


def _reciprocal(n: int) -> float:
    return float(torch.tensor(1.0 / n, dtype=torch.float32))


def _pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The uncompressed mean, summed in rank order as XLA sums the
    reference's ``pmean`` (an ``all_reduce`` sums in its backend's own
    order, which differs by an ulp where terms cancel); small leaves
    only, so gathering them costs nothing."""
    world = dist.get_world_size(group)
    xs = x.new_empty(world * x.numel())
    dist.all_gather_into_tensor(xs, x.reshape(-1), group=group)
    xs = xs.reshape((world,) + tuple(x.shape))
    acc = xs[0]
    for r in range(1, world):
        acc = acc + xs[r]
    return acc * _reciprocal(world)


def compressed_pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over ``group`` moving int8 codes and f32 scales instead of
    f32 values."""
    q, scale = _chunk_quant(x)
    return _gathered_mean(q, scale, x.shape, group)


def compressed_grad_mean(grads: Any, group=None) -> Any:
    """Tree-wide compressed mean (leaves of at least ``CHUNK`` elements;
    smaller ones are averaged uncompressed)."""
    def one(g):
        if g.numel() >= CHUNK:
            return compressed_pmean(g, group)
        return _pmean(g, group)
    return tree_map(one, grads)


class ErrorFeedback:
    """Residual accumulator: feed ``apply`` the raw grad, get the
    compressed-communicated grad plus the carried quantization
    residual."""

    @staticmethod
    def init(grads):
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                        grads)

    @staticmethod
    def apply(grads, residual, group=None):
        """``(mean, new_residual)``: the group mean of ``grads + residual``
        (in each grad's dtype) and this rank's quantization error."""
        residuals = []

        def one(g, r):
            gf = g.float() + r
            if g.numel() >= CHUNK:
                q, scale = _chunk_quant(gf)
                # XLA fuses the dequantize product into the difference
                # (one fma): exact in float64, rounded once
                residuals.append((gf.double() - _reshape(
                    q.double() * scale.double(), gf.shape)).float())
                mean = _gathered_mean(q, scale, gf.shape, group)
            else:
                residuals.append(torch.zeros_like(gf))
                mean = _pmean(gf, group)
            return mean.to(g.dtype)
        out = tree_map(one, grads, residual)
        it = iter(residuals)
        return out, tree_map(lambda _: next(it), grads)
