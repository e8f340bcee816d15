"""Symmetric int8 quantization — the numerical core of MPAI's DPU path.

Implements per-channel / per-tensor symmetric absmax quantization and
``pdot``, the precision-dispatched matmul every model layer calls.  A
segment's :class:`~repro_torch.core.precision.PrecisionPolicy` decides
whether a matmul runs raw (bf16/fp32) or truly quantized (the int8 GEMM
kernel).  Fake quantization (QAT training) is a later slice of the port.

The arithmetic follows the reference step for step, because the int8
codes and the int32 accumulators must come out equal: the scale is
``max(absmax, 1e-8) / 127``, codes are ``round(x / scale)`` with a true
division and round-half-to-even, and the epilogue is
``(acc.f32 * x_scale) * w_scale`` before the cast to bf16.  The scale is
computed as XLA runs the reference (see ``_absmax_scale``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.precision import DEFAULT_POLICY, PrecisionPolicy
from repro_torch.core.tree import tree_map
from repro_torch.kernels import ops as kops

INT8_QMAX = 127.0
INV_QMAX = float(torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32))


class QTensor(NamedTuple):
    """An int8 tensor with its dequantization scale.

    ``scale`` broadcasts against ``values``: per-tensor -> shape (1,)*ndim,
    per-channel -> 1 everywhere except the channel axis.
    """
    values: torch.Tensor               # int8
    scale: torch.Tensor                # f32, values ≈ float / scale

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        return (self.values.float() * self.scale).to(dtype)


def _absmax_scale(x: torch.Tensor, axis) -> torch.Tensor:
    amax = torch.amax(x.float().abs(), dim=axis, keepdim=True)
    # the reference writes ``/ 127``; XLA folds a division by a constant
    # into a multiply by its f32 reciprocal, and the scales (and so the
    # codes) only match that way
    return amax.clamp_min(1e-8) * INV_QMAX


def quantize(x: torch.Tensor, channel_axis: Optional[int] = None,
             batch_axes: tuple = ()) -> QTensor:
    """Symmetric absmax quantization to int8.

    ``channel_axis``: axis that keeps its own scale (None -> per-tensor).
    ``batch_axes``: additional axes that keep independent scales (e.g. the
    stacked-layer dim of stacked weights).
    """
    if channel_axis is None:
        axis = tuple(i for i in range(x.ndim) if i not in
                     tuple(a % x.ndim for a in batch_axes))
        axis = axis or tuple(range(x.ndim))
    else:
        channel_axis = channel_axis % x.ndim
        keep = {channel_axis, *(a % x.ndim for a in batch_axes)}
        axis = tuple(i for i in range(x.ndim) if i not in keep)
    scale = _absmax_scale(x, axis)
    q = torch.div(x.float(), scale).round_().clamp_(-INT8_QMAX, INT8_QMAX)
    return QTensor(q.to(torch.int8), scale)


def _int8_dot(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x: [..., K] float;  w: QTensor [K, N] (per-out-channel scales)."""
    xq = quantize(x)                                        # per-tensor dynamic
    lead = xq.values.shape[:-1]
    xm = xq.values.reshape(-1, xq.values.shape[-1])
    acc = kops.int8_matmul(xm, w.values)                   # int32 [M, N]
    out = acc.float() * xq.scale * w.scale.reshape(1, -1)
    return out.reshape(*lead, -1).to(torch.bfloat16)


def pdot(x: torch.Tensor, w, policy: PrecisionPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Precision-dispatched ``x @ w``.

    ``w`` is either a float tensor [K, N] (cast or quantized at use) or a
    :class:`QTensor` (weights pre-quantized offline).
    """
    if policy.mode == "quant":
        if not isinstance(w, QTensor):
            w = quantize(w, channel_axis=-1 if policy.per_channel else None)
        return _int8_dot(x, w)
    if policy.mode != "raw":
        raise NotImplementedError(
            f"pdot mode {policy.mode!r}: fake quantization (QAT) is not "
            f"ported yet")
    dt = policy.precision.compute_dtype
    if isinstance(w, QTensor):       # pre-quantized checkpoint, raw segment
        w = w.dequantize(dt)
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
