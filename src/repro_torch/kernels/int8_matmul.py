"""int8 x int8 -> int32 matrix product: the CUDA kernel and its plain version.

Replaces the TPU kernel ``int8_matmul_pallas`` (``repro/kernels/
int8_matmul.py``).  On the serving path the product runs at decode with M =
live slots (<= 8), where it is bound by the K*N weight bytes it reads; the
kernel (``csrc/int8_matmul.cu``) tiles the output 32 x 64 with ``__dp4a`` on
CUDA cores and splits K across blocks when the output tiles alone would
leave SMs idle, masking ragged edges instead of padding.  Results are
integers, so the kernel equals the plain version exactly.

PyTorch has no int8 matrix product of its own on CUDA (``torch._int_mm`` is
a cuBLAS call), so every CUDA int8 product of the port goes through this
kernel, whatever the policy's ``use_pallas`` says; the reference's two
branches give equal int32 results.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

BM, BN, BK = 32, 64, 64          # the kernel's tile (csrc/int8_matmul.cu)
BLOCKS_PER_SM = 4                # grid size K splits aim for, per SM
# x, w, out, m, k, n, splits, stream (csrc/int8_matmul.cu)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] int8, w: [K, N] int8 -> [M, N] int32.  Exact: int32 on the
    CPU, float64 on CUDA (which has no integer matmul; exact while every
    partial sum stays below 2**53)."""
    if x.is_cuda:
        return (x.double() @ w.double()).to(torch.int32)
    return x.to(torch.int32) @ w.to(torch.int32)


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def k_splits(m: int, k: int, n: int, sms: int) -> int:
    """Blocks along K: enough that the grid reaches ``BLOCKS_PER_SM * sms``."""
    tiles = -(-n // BN) * -(-m // BM)
    k_tiles = -(-k // BK)
    want = min(k_tiles, max(1, -(-BLOCKS_PER_SM * sms // tiles)))
    per_split = -(-k_tiles // want)
    return -(-k_tiles // per_split)


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [M, K] int8, w: [K, N] int8 -> [M, N] int32.

    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not multiply")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8, got {x.dtype} x {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"int8_matmul: x on {x.device}, w on {w.device}")
    if not x.is_cuda:
        return int8_matmul_plain(x, w)
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    x, w = x.contiguous(), w.contiguous()
    splits = k_splits(m, k, n, sm_count(x.device.index))
    out = (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=x.device)
    fn = build.entry("int8_matmul", "int8_matmul_s8s32", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                   splits, stream), "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
