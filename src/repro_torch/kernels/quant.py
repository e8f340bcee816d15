"""Row-wise absmax int8 quantization: the CUDA kernel and its plain version.

Replaces the TPU kernel ``rowwise_quant_pallas`` (``repro/kernels/
quant.py``).  Per row: ``scale = max(absmax, 1e-8) / 127`` and ``q =
clip(round(x / scale), -127, 127)`` as int8, which is also what the int8 KV
cache's ``attention._cache_quant`` computes per token and head, so that
function routes here.  The scale is computed as XLA runs the reference under
``jit`` (the reference's servers are jitted): the division by 127 is folded
into a product with the f32 reciprocal ``INV_QMAX``.  ``x / scale`` is a
true division and rounding is half to even, so the kernel's codes and
scales equal the plain version's bit for bit.

The kernel (``csrc/rowwise_quant.cu``) is bound by its bytes (and by the
launch at the KV cache's 64-row decode shape): one warp per row, a shuffle
reduction for the absmax, any M and K.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

INT8_QMAX = 127.0
INV_QMAX = float(torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32))
_ENTRIES = {torch.bfloat16: "rowwise_quant_bf16",
            torch.float32: "rowwise_quant_f32"}
# x, q, scale, m, k, inv_qmax, stream (csrc/rowwise_quant.cu)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_void_p])


def rowwise_quant_plain(x: torch.Tensor):
    """x: [M, K] float -> (q [M, K] int8, scale [M, 1] f32)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV_QMAX
    q = torch.div(xf, scale).round_().clamp_(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def rowwise_quant(x: torch.Tensor):
    """x: [M, K] bf16 or f32 -> (q [M, K] int8, scale [M, 1] f32).

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if x.ndim != 2:
        raise ValueError(f"rowwise_quant takes [M, K], got {tuple(x.shape)}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"rowwise_quant takes bf16 or f32, got {x.dtype}")
    if not x.is_cuda:
        return rowwise_quant_plain(x)
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, scale
    x = x.contiguous()
    fn = build.entry("rowwise_quant", _ENTRIES[x.dtype], _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(), m, k,
                   INV_QMAX, stream), "rowwise_quant")
    rowwise_quant.launches += 1
    return q, scale


rowwise_quant.launches = 0
