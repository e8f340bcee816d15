"""Symmetric int8 quantization — the numerical core of MPAI's DPU path.

Implements per-channel / per-tensor symmetric absmax quantization, fake
quantization with a straight-through gradient (QAT, the paper's
partition-aware training) and ``pdot``, the precision-dispatched matmul
every model layer calls.  A segment's
:class:`~repro_torch.core.precision.PrecisionPolicy` decides whether a
matmul runs raw (bf16/fp32), fake-quantized (training an int8 segment) or
truly quantized (the int8 GEMM kernel).

The arithmetic follows the reference step for step, because the int8
codes and the int32 accumulators must come out equal: the scale is
``max(absmax, 1e-8) / 127``, codes are ``round(x / scale)`` with a true
division and round-half-to-even, and the epilogue is
``(acc.f32 * x_scale) * w_scale`` before the cast to bf16.  The scale is
computed as XLA runs the reference (see ``_absmax_scale``).

An activation's per-tensor scale (``activation=True``: ``pdot``'s input,
the int8 GEMM's input, MoE's dispatch buffer) is the reference's absmax
over the global batch: inside a mesh step's batch group
(``core/collectives.py``) the rank's absmax is all-reduced with ``MAX``.

Inside the model group a weight may be the rank's part of a split one
(``pdot(..., split=)``, said by the caller: ``"col"`` for a
column-parallel weight ``[K, N / tp]``, ``"row"`` for a row-parallel one
``[K / tp, N]`` whose input is split on its last dim).  A scale whose
absmax spans the split (``split=True`` below: a row-parallel weight's
per-column scale, any per-tensor scale of a split weight, a row-parallel
input's) takes ``model_max`` too, an exact maximum.  A row-parallel int8
product all-reduces its int32 accumulator, exactly, before the epilogue,
so it is bit-equal to the unsplit product; a float one all-reduces f32
partials and rounds to the compute dtype once, as the unsplit product
rounds once.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import collectives
from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quant import INT8_QMAX, INV_QMAX


class QTensor(NamedTuple):
    """An int8 tensor with its dequantization scale.

    ``scale`` broadcasts against ``values``: per-tensor -> shape (1,)*ndim,
    per-channel -> 1 everywhere except the channel axis.
    """
    values: torch.Tensor               # int8
    scale: torch.Tensor                # f32, values ≈ float / scale

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.values.float() * self.scale).to(dtype)


def _absmax_scale(x: torch.Tensor, axis, activation: bool = False,
                  split: bool = False) -> torch.Tensor:
    amax = torch.amax(x.float().abs(), dim=axis, keepdim=True)
    if activation:
        amax = collectives.batch_max(amax)
    if split:
        amax = collectives.model_max(amax)
    # the reference writes ``/ 127``; XLA folds a division by a constant
    # into a multiply by its f32 reciprocal, and the scales (and so the
    # codes) only match that way
    return amax.clamp_min(1e-8) * INV_QMAX


def quantize(x: torch.Tensor, channel_axis: Optional[int] = None,
             batch_axes: tuple = (), activation: bool = False,
             split: bool = False) -> QTensor:
    """Symmetric absmax quantization to int8.

    ``channel_axis``: axis that keeps its own scale (None -> per-tensor).
    ``batch_axes``: additional axes that keep independent scales (e.g. the
    stacked-layer dim of stacked weights).  ``activation``: ``x``'s rows
    are the rank's part of the batch group's; ``split``: the reduced axes
    are the rank's part of the model group's (module docstring).
    """
    if channel_axis is None:
        axis = tuple(i for i in range(x.ndim) if i not in
                     tuple(a % x.ndim for a in batch_axes))
        axis = axis or tuple(range(x.ndim))
    else:
        channel_axis = channel_axis % x.ndim
        keep = {channel_axis, *(a % x.ndim for a in batch_axes)}
        axis = tuple(i for i in range(x.ndim) if i not in keep)
    scale = _absmax_scale(x, axis, activation, split)
    q = torch.div(x.float(), scale).round_().clamp_(-INT8_QMAX, INT8_QMAX)
    return QTensor(q.to(torch.int8), scale)


def fake_quant(x: torch.Tensor, channel_axis: Optional[int] = None,
               activation: bool = False, split: bool = False) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient.

    Forward: the round trip through the int8 grid, written as the
    reference writes it, ``x + (dq - x)`` with the difference detached (its
    value is ``dq``: a nonzero ``dq`` lies within a factor of 2 of ``x``,
    so the difference is exact).  Backward: the identity (the STE)."""
    with torch.no_grad():
        dq = quantize(x, channel_axis, activation=activation,
                      split=split).dequantize(torch.float32).to(x.dtype)
        delta = dq - x
    return x + delta


def _int8_dot(x: torch.Tensor, w: QTensor, row: bool = False) -> torch.Tensor:
    """x: [..., K] float;  w: QTensor [K, N] (per-out-channel scales).
    ``row``: a row-parallel product (module docstring)."""
    xq = quantize(x, activation=True, split=row)           # per-tensor dynamic
    lead = xq.values.shape[:-1]
    xm = xq.values.reshape(-1, xq.values.shape[-1])
    acc = kops.int8_matmul(xm, w.values)                   # int32 [M, N]
    if row:
        acc = collectives.from_model(acc)                  # exact
    out = acc.float() * xq.scale * w.scale.reshape(1, -1)
    return out.reshape(*lead, -1).to(torch.bfloat16)


def _f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``x`` [..., K], ``w`` [K, N], one dtype) with the result
    in f32: a 16-bit product rounded once after the sum over ranks."""
    xm = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = xm @ w
    elif x.is_cuda:              # cuBLAS: 16-bit operands, f32 output
        out = torch.mm(xm, w, out_dtype=torch.float32)
    else:                        # 16-bit products are exact in f32
        out = xm.float() @ w.float()
    return out.reshape(*x.shape[:-1], -1)


class _RowProduct(torch.autograd.Function):
    """A row-parallel ``x @ w`` in f32 (the rank's partial sum); the
    backward is the unsplit product's, in the operands' dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return _f32_mm(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.matmul(g, w.T)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx, dw


class _ColumnProduct(torch.autograd.Function):
    """A column-parallel ``x @ w`` (the rank's columns).  The backward
    takes ``x``'s gradient as the f32 partial ``g @ w.T`` all-reduced over
    the model group and rounded once, as the unsplit product rounds it
    (the conjugate of a row-parallel product); ``w``'s gradient is the
    unsplit product's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = _f32_mm(g, w.T)
        dist.all_reduce(dx, group=ctx.group)
        dw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dx.to(x.dtype), dw, None


def _float_weight(w, policy: PrecisionPolicy, split: Optional[str]):
    """``w`` for a float-mode product (``"raw"`` or ``"fake"``): dequantized
    or fake-quantized with the scales the split asks for (module
    docstring), in the compute dtype."""
    dt = policy.precision.compute_dtype
    if isinstance(w, QTensor):       # pre-quantized checkpoint, raw segment
        w = w.dequantize(dt)
    if policy.mode == "fake":
        w = fake_quant(w, channel_axis=-1 if policy.per_channel else None,
                       split=_weight_split(policy, split))
    return w.to(dt)


def _float_input(x: torch.Tensor, policy: PrecisionPolicy,
                 split: Optional[str]) -> torch.Tensor:
    """``x`` for a float-mode product, fake-quantized per tensor (its
    absmax over the ranks where it is a row-parallel input), in the
    compute dtype."""
    if policy.mode == "fake":
        x = fake_quant(x, activation=True,
                       split=collectives.model_ranks() > 1
                       and split == "row")
    return x.to(policy.precision.compute_dtype)


def _weight_split(policy: PrecisionPolicy, split: Optional[str]) -> bool:
    """Whether a split weight's scale spans the ranks: it reduces over K
    (a row-parallel weight) or over every entry (per-tensor)."""
    return (collectives.model_ranks() > 1 and split is not None
            and (split == "row" or not policy.per_channel))


def pdot(x: torch.Tensor, w, policy: PrecisionPolicy = DEFAULT_POLICY,
         split: Optional[str] = None) -> torch.Tensor:
    """Precision-dispatched ``x @ w``.

    ``w`` is either a float tensor [K, N] (cast, fake-quantized or
    quantized at use) or a :class:`QTensor` (weights pre-quantized
    offline).  ``split``: ``None`` (``w`` whole), ``"col"`` or ``"row"``
    (``w`` the rank's part of a column- or row-parallel weight inside the
    model group; module docstring).  A row-parallel product returns the
    whole sum, replicated, and passes its gradient through; a
    column-parallel one returns the rank's columns and sums its input's
    gradient over the ranks (``_ColumnProduct``).  Each product reduces
    on its own: the unsplit backward rounds each product's input gradient
    once and adds the products' in the compute dtype, and so does this.
    """
    if split not in (None, "col", "row"):
        raise ValueError(f"pdot: split {split!r}")
    parts = collectives.model_ranks() > 1
    if policy.mode == "quant":
        if not isinstance(w, QTensor):
            w = quantize(w, channel_axis=-1 if policy.per_channel else None,
                         split=_weight_split(policy, split))
        return _int8_dot(x, w, parts and split == "row")
    x, w = _float_input(x, policy, split), _float_weight(w, policy, split)
    if not parts or split is None:
        return torch.matmul(x, w)
    if split == "col":
        return _ColumnProduct.apply(x, w, collectives.model_process_group())
    return collectives.from_model(_RowProduct.apply(x, w)).to(x.dtype)


def quantize_params(params, channel_axis: int = -1, stacked: bool = False):
    """Offline weight quantization of a param tree: every float matrix
    with ndim >= 2 becomes a QTensor (per-out-channel); vectors (norms,
    biases) stay float.  ``stacked``: leading dim is a layer stack that
    keeps independent scales."""
    def _q(p):
        if isinstance(p, torch.Tensor) and p.ndim >= 2 and p.is_floating_point():
            batch = (0,) if (stacked and p.ndim >= 3) else ()
            return quantize(p, channel_axis=channel_axis, batch_axes=batch)
        return p
    return tree_map(_q, params)


def quantization_error(x: torch.Tensor,
                       channel_axis: Optional[int] = None) -> torch.Tensor:
    """Max abs round-trip error — bounded by scale/2 (property-tested).
    ``codes * scale - x`` is rounded once, as XLA's CPU code fuses it into
    one fma (the product is exact in float64)."""
    qt = quantize(x, channel_axis)
    err = (qt.values.double() * qt.scale.double() - x.double()).float()
    return torch.max(torch.abs(err))
