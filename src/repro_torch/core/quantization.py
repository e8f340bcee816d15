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
Weights are whole on every rank and keep their own.
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


def _absmax_scale(x: torch.Tensor, axis,
                  activation: bool = False) -> torch.Tensor:
    amax = torch.amax(x.float().abs(), dim=axis, keepdim=True)
    if activation:
        amax = collectives.batch_max(amax)
    # the reference writes ``/ 127``; XLA folds a division by a constant
    # into a multiply by its f32 reciprocal, and the scales (and so the
    # codes) only match that way
    return amax.clamp_min(1e-8) * INV_QMAX


def quantize(x: torch.Tensor, channel_axis: Optional[int] = None,
             batch_axes: tuple = (), activation: bool = False) -> QTensor:
    """Symmetric absmax quantization to int8.

    ``channel_axis``: axis that keeps its own scale (None -> per-tensor).
    ``batch_axes``: additional axes that keep independent scales (e.g. the
    stacked-layer dim of stacked weights).  ``activation``: ``x``'s rows
    are the rank's part of the batch group's (module docstring).
    """
    if channel_axis is None:
        axis = tuple(i for i in range(x.ndim) if i not in
                     tuple(a % x.ndim for a in batch_axes))
        axis = axis or tuple(range(x.ndim))
    else:
        channel_axis = channel_axis % x.ndim
        keep = {channel_axis, *(a % x.ndim for a in batch_axes)}
        axis = tuple(i for i in range(x.ndim) if i not in keep)
    scale = _absmax_scale(x, axis, activation)
    q = torch.div(x.float(), scale).round_().clamp_(-INT8_QMAX, INT8_QMAX)
    return QTensor(q.to(torch.int8), scale)


def fake_quant(x: torch.Tensor, channel_axis: Optional[int] = None,
               activation: bool = False) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient.

    Forward: the round trip through the int8 grid, written as the
    reference writes it, ``x + (dq - x)`` with the difference detached (its
    value is ``dq``: a nonzero ``dq`` lies within a factor of 2 of ``x``,
    so the difference is exact).  Backward: the identity (the STE)."""
    with torch.no_grad():
        dq = quantize(x, channel_axis, activation=activation).dequantize(
            torch.float32).to(x.dtype)
        delta = dq - x
    return x + delta


def _int8_dot(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x: [..., K] float;  w: QTensor [K, N] (per-out-channel scales)."""
    xq = quantize(x, activation=True)                      # per-tensor dynamic
    lead = xq.values.shape[:-1]
    xm = xq.values.reshape(-1, xq.values.shape[-1])
    acc = kops.int8_matmul(xm, w.values)                   # int32 [M, N]
    out = acc.float() * xq.scale * w.scale.reshape(1, -1)
    return out.reshape(*lead, -1).to(torch.bfloat16)


def pdot(x: torch.Tensor, w, policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Precision-dispatched ``x @ w``.

    ``w`` is either a float tensor [K, N] (cast, fake-quantized or
    quantized at use) or a :class:`QTensor` (weights pre-quantized
    offline).
    """
    if policy.mode == "quant":
        if not isinstance(w, QTensor):
            w = quantize(w, channel_axis=-1 if policy.per_channel else None)
        return _int8_dot(x, w)
    dt = policy.precision.compute_dtype
    if isinstance(w, QTensor):       # pre-quantized checkpoint, raw segment
        w = w.dequantize(dt)
    if policy.mode == "fake":
        w = fake_quant(w, channel_axis=-1 if policy.per_channel else None)
        x = fake_quant(x, activation=True)
    return torch.matmul(x.to(dt), w.to(dt))


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
